"""Random split protocols (port of `infomax3d_tpu/data/splits.py`: the
reference's `get_random_indices` and the per-family random splits).  The
OGB scaffold split comes with the data layer (ROADMAP queue 1, item 4) and
raises until then."""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def get_random_indices(length: int, seed: int = 123) -> np.ndarray:
    """Split-index parity with reference commons/utils.py:31-36: a
    permutation from numpy's global generator seeded with `seed`, whose
    state is restored afterwards."""
    st0 = np.random.get_state()
    np.random.seed(seed)
    idx = np.random.permutation(length)
    np.random.set_state(st0)
    return idx


def get_idx_split(*_args, **_kwargs):
    raise NotImplementedError(
        "OGB scaffold splits are not ported yet (ROADMAP queue 1, item 4)")


# model-pool sizes per dataset family (reference train.py:504-515)
_MODEL_POOL = {
    "drugs": 280_000,
    "qmugs": 620_000,
    "file_loader_qm9": 80_000,
    "file_loader_drugs": 160_000,
    "geom_qm9": 100_000,
    "qm9_geomol_feat": 100_000,
}


def reference_split_indices(args: Dict, n: int
                            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(train_idx, val_idx, test_idx) per the reference's random protocol:

    * qm9 family (`train.py:566-585`): model pool = first 100k, test = 10%,
      val = rest; `num_val` switches to the contiguous
      [:num_train][num_train:+num_val][+num_val:+2num_val] layout.
    * geom family (`train.py:503-521`): family-specific model pool, test =
      5%, val = rest; file_loader sets clamp val to the last <=1000.
    """
    name = args["dataset"]
    all_idx = get_random_indices(n, args["seed_data"])
    geom_family = name in _MODEL_POOL
    pool = _MODEL_POOL.get(name, 100_000)
    if n < pool:
        pool = int(n * 0.8)
    model_idx = all_idx[:pool]
    test_frac = 0.05 if geom_family else 0.1
    test_idx = all_idx[len(model_idx): len(model_idx) + int(test_frac * n)]
    if name in ("file_loader_drugs", "file_loader_qm9"):
        val_idx = all_idx[max(len(model_idx) + len(test_idx), n - 1000):]
    else:
        val_idx = all_idx[len(model_idx) + len(test_idx):]
    num_train = args.get("num_train", -1)
    train_idx = model_idx[:num_train] if num_train and num_train > 0 \
        else model_idx
    num_val = args.get("num_val")
    if num_val and name.startswith("qm9"):
        # reference train.py:576-580
        train_idx = all_idx[:num_train] if num_train and num_train > 0 \
            else all_idx
        val_idx = all_idx[len(train_idx): len(train_idx) + num_val]
        test_idx = all_idx[len(train_idx) + num_val:
                           len(train_idx) + 2 * num_val]
    elif num_val:
        val_idx = val_idx[:num_val]
    return train_idx, val_idx, test_idx

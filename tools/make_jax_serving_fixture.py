#!/usr/bin/env python3
"""Write `tests/fixtures/jax_serving/`: a checkpoint trained by the JAX
package's CLI, with what its serving and fine-tune transfer give, for the
port's tests and `chip_smoke.py` phase 20 to hold the port against.

    python tools/make_jax_serving_fixture.py     # from the repository root

Runs the JAX package on the CPU (it is never run on the card).  Writes:

* `best_checkpoint.pt`, `train_arguments.yaml`: `configs_clean/
  pre-train_synthetic.yml` (PNA + Net3D, NT-Xent) cut to PNA 16x2 and
  Net3D hidden 8, trained by the JAX CLI for 1 epoch of 2 steps on 512
  synthetic molecules.  The checkpoint is the JAX package's flax msgpack
  of its `TrainState`; the arguments' `logdir` is reset to `runs`.
* `smiles.txt`: 64 drug-like SMILES of 20 to 70 heavy atoms
  (`chip_smoke.drug_smiles`, seed `SMILES_SEED`).
* `fingerprints.npy`: the JAX CLI's `inference` of those SMILES from that
  checkpoint (float32 [64, 64]).
* `fixture.json`: the fine-tune the JAX CLI runs from that checkpoint
  (`configs_clean/tune_synthetic.yml` at the same widths, with the
  `transfer_layers` / `exclude_from_transfer` of `configs/tune_pna.yml`,
  1 step) and the number of parameter tensors its transfer copied.
"""
import contextlib
import glob
import io
import json
import os
import re
import shutil
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "tests" / "fixtures" / "jax_serving"
PRE = "configs_clean/pre-train_synthetic.yml"
TUNE = "configs_clean/tune_synthetic.yml"
TUNE_FILTER = "configs/tune_pna.yml"
SMILES_SEED = 13
WIDTHS = {"hidden_dim": 16, "propagation_depth": 2, "readout_hidden_dim": 16}
DATA = {"num": 512, "n_max": 24}
# the JAX CLI's CPU-friendly batch layout (its XLA segment path)
JAX_ONLY = {"csr_buckets": False, "dense_3d": True}


def _overrides(config: str, **extra) -> dict:
    import yaml
    cfg = yaml.safe_load(open(config))
    out = {"model_parameters": dict(cfg["model_parameters"], **WIDTHS),
           "dataset_params": DATA, "num_epochs": 1,
           "use_tensorboard": False, "multithreaded_seeds": []}
    if cfg.get("model3d_parameters"):
        out["model3d_parameters"] = dict(cfg["model3d_parameters"],
                                         hidden_dim=8, readout_hidden_dim=8)
    out.update(extra)
    return out


def main():
    os.chdir(ROOT)
    sys.path.insert(0, str(ROOT))
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    import yaml
    from infomax3d_tpu.cli import train as jax_cli
    from infomax3d_tpu.cli.config import load_config
    from infomax3d_tpu.cli.inference import inference
    from chip_smoke import drug_smiles

    shutil.rmtree(OUT, ignore_errors=True)
    OUT.mkdir(parents=True)
    with tempfile.TemporaryDirectory() as tmp:
        jax_cli.train(load_config(PRE, dict(
            _overrides(PRE, num_train=64, batch_size=32), logdir=tmp,
            **JAX_ONLY)))
        run, = glob.glob(os.path.join(tmp, "*", "best_checkpoint.pt"))
        shutil.copy(run, OUT / "best_checkpoint.pt")
        saved = yaml.safe_load(open(Path(run).parent / "train_arguments.yaml"))
    saved["logdir"] = "runs"
    with open(OUT / "train_arguments.yaml", "w") as f:
        yaml.safe_dump(saved, f)

    smiles = drug_smiles(64, SMILES_SEED)
    (OUT / "smiles.txt").write_text("\n".join(smiles) + "\n")
    ckpt = str((OUT / "best_checkpoint.pt").relative_to(ROOT))
    fp = inference(load_config(None, {
        "checkpoint": ckpt, "smiles_txt_path": str(OUT / "smiles.txt"),
        "output_path": str(OUT / "fingerprints.npy")}))
    assert fp.shape[0] == 64 and np.isfinite(fp).all()

    tf = yaml.safe_load(open(TUNE_FILTER))
    tune = _overrides(TUNE, num_train=32, batch_size=32,
                      transfer_layers=tf["transfer_layers"],
                      exclude_from_transfer=tf["exclude_from_transfer"])
    text = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp, \
            contextlib.redirect_stdout(text):
        jax_cli.train(load_config(TUNE, dict(
            tune, pretrain_checkpoint=ckpt, logdir=tmp, **JAX_ONLY)))
    count = int(re.search(r"transferred (\d+) parameter tensors",
                          text.getvalue()).group(1))
    meta = {"smiles_seed": SMILES_SEED, "tune_config": TUNE,
            "tune_overrides": tune, "transfer_count": count,
            "jax": jax.__version__}
    (OUT / "fixture.json").write_text(json.dumps(meta, indent=1) + "\n")
    size = sum(p.stat().st_size for p in OUT.iterdir())
    print(f"wrote {OUT.relative_to(ROOT)}: {size} bytes, transfer count "
          f"{count}")


if __name__ == "__main__":
    main()

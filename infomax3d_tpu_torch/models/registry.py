"""Model registry (port of `infomax3d_tpu/models/registry.py`): the
`model_type` names of the configs mapped to the port's classes.

Each entry keeps the JAX class's field names (`JAX_FIELDS`): a config key
that is not a field is dropped, as the JAX package's `_adapt_model_params`
drops it, and a field the port's class lacks raises when the config sets
it to anything but the JAX default (`UNPORTED_FIELDS`).  `Net3D` is the
flat 3D network on CSR complete graphs; the CLI swaps it for the
parameter-compatible `Net3DDense` when `_dense_3d` is on, as the JAX
package does.  `Net3DVAE` names `Net3DAE` (`MODEL_ALIASES`, the JAX
table: the reference's configs name a class that exists nowhere).  The OT
generator's backbones (`gnn_model`: `PNAGNNRandom`, `GeomolGNNOGBFeat`
and the others) are in `optimal_transport.BACKBONES`, each class with its
JAX fields as `FIELDS`.  A name the JAX package registers and the port
does not have yet raises `NotImplementedError` with its ROADMAP queue 1
item (`NOT_PORTED`); any other name raises `KeyError`, as the JAX
registry does.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

from torch import nn

from infomax3d_tpu_torch.models.byol import BYOLWrapper
from infomax3d_tpu_torch.models.egnn import EGNN
from infomax3d_tpu_torch.models.egnn_dense import DenseEGNN
from infomax3d_tpu_torch.models.geomol_mpnn import GeomolGNNWrapperOGBFeat
from infomax3d_tpu_torch.models.gin import OGBGNN
from infomax3d_tpu_torch.models.net3d import Net3D, Net3DDense
from infomax3d_tpu_torch.models.net3d_vae import (Net3DAE,
                                                  Net3DDistancePredictor)
from infomax3d_tpu_torch.models.optimal_transport import OptimalTransportModel
from infomax3d_tpu_torch.models.pna import PNA
from infomax3d_tpu_torch.models.pna_original import (PNAOriginal,
                                                     PNAOriginalSimple)
from infomax3d_tpu_torch.models.random_variants import (
    OGBGNNRandom, PNAOriginalRandom, PNAOriginalSimpleRandom)
from infomax3d_tpu_torch.models.san import SAN
from infomax3d_tpu_torch.models.smp import SMP
from infomax3d_tpu_torch.models.transformer import (DistancePredictor,
                                                    PNADistancePredictor,
                                                    PNATransformer,
                                                    TransformerPlain)

_NET3D_FIELDS = ("hidden_dim", "target_dim", "readout_aggregators",
                 "batch_norm", "node_wise_output_layers",
                 "readout_batchnorm", "batch_norm_momentum", "reduce_func",
                 "dropout", "propagation_depth", "readout_layers",
                 "readout_hidden_dim", "fourier_encodings", "activation",
                 "update_net_layers", "message_net_layers",
                 "use_node_features")

_NET3DAE_SHARED = ("hidden_dim", "readout_aggregators", "batch_norm",
                   "node_wise_encoder_layers", "node_wise_output_layers",
                   "batch_norm_momentum", "reduce_func", "dropout",
                   "decoder_depth", "projection_dim", "distance_net",
                   "projection_layers", "fourier_encodings", "activation",
                   "update_net_layers", "message_net_layers",
                   "use_node_features")

MODEL_REGISTRY: Dict[str, type] = {
    "PNA": PNA, "OGBGNN": OGBGNN, "Net3D": Net3D, "Net3DDense": Net3DDense,
    "OptimalTransportModel": OptimalTransportModel,
    "DistancePredictor": DistancePredictor,
    "PNADistancePredictor": PNADistancePredictor, "Net3DAE": Net3DAE,
    "Net3DDistancePredictor": Net3DDistancePredictor,
    "GeomolGNNWrapperOGBFeat": GeomolGNNWrapperOGBFeat,
    "OGBGNNRandom": OGBGNNRandom, "PNATransformer": PNATransformer,
    "TransformerPlain": TransformerPlain, "PNAOriginal": PNAOriginal,
    "PNAOriginalRandom": PNAOriginalRandom,
    "PNAOriginalSimple": PNAOriginalSimple,
    "PNAOriginalSimpleRandom": PNAOriginalSimpleRandom, "SMP": SMP,
    "EGNN": EGNN, "EGNNTorch": DenseEGNN, "SAN": SAN,
    "BYOLwrapper": BYOLWrapper}

# the JAX package's other registered names and the ROADMAP queue 1 item
# that ports each
NOT_PORTED: Dict[str, str] = {
    **{n: "7g" for n in ("GeomolGNNWrapper",
                         "GeomolGNNWrapperOGBFeatRandom",
                         "GeomolGNNWrapperOGBFeatRandomNonShared",
                         "PNARandom", "PNARandomEdgeUpdate",
                         "PNAGNNRandomEdgeUpdate")},
    "Critic": "8b"}

# reference YAML names whose class the reference cannot resolve, mapped
# onto the class the config means (the JAX package's models/registry.py)
MODEL_ALIASES: Dict[str, str] = {"Net3DVAE": "Net3DAE"}

# the JAX dataclass fields of each registered class
JAX_FIELDS: Dict[str, tuple] = {
    "PNA": ("hidden_dim", "target_dim", "aggregators", "scalers",
            "readout_aggregators", "readout_batchnorm", "readout_hidden_dim",
            "readout_layers", "residual", "pairwise_distances", "activation",
            "last_activation", "mid_batch_norm", "last_batch_norm",
            "propagation_depth", "dropout", "posttrans_layers",
            "pretrans_layers", "batch_norm_momentum"),
    "OGBGNN": OGBGNN.FIELDS,
    "Net3D": _NET3D_FIELDS,
    "Net3DDense": _NET3D_FIELDS,
    "OptimalTransportModel": ("hyperparams", "gnn_params", "gnn_model",
                              "use_transformer", "use_two_gnns"),
    "DistancePredictor": ("pna_args", "target_dim", "projection_dim",
                          "distance_net", "projection_layers",
                          "transformer_layer", "nhead", "dim_feedforward",
                          "activation", "max_nodes"),
    "PNADistancePredictor": (
        "hidden_dim", "aggregators", "scalers", "target_dim",
        "readout_aggregators", "residual", "pairwise_distances",
        "activation", "last_activation", "mid_batch_norm", "last_batch_norm",
        "propagation_depth", "dropout", "projection_layers",
        "projection_dim", "posttrans_layers", "pretrans_layers",
        "batch_norm_momentum", "readout_batchnorm", "readout_hidden_dim",
        "readout_layers"),
    "Net3DAE": _NET3DAE_SHARED + ("encoder_depth", "target_dim",
                                  "readout_batchnorm", "readout_layers",
                                  "readout_hidden_dim", "propagation_depth"),
    "Net3DDistancePredictor": _NET3DAE_SHARED + ("propagation_depth",),
    "GeomolGNNWrapperOGBFeat": GeomolGNNWrapperOGBFeat.FIELDS,
    "OGBGNNRandom": OGBGNNRandom.FIELDS,
    "PNATransformer": PNATransformer.FIELDS,
    "TransformerPlain": TransformerPlain.FIELDS,
    "PNAOriginal": PNAOriginal.FIELDS,
    "PNAOriginalRandom": PNAOriginal.FIELDS,
    "PNAOriginalSimple": PNAOriginalSimple.FIELDS,
    "PNAOriginalSimpleRandom": PNAOriginalSimpleRandom.FIELDS,
    "SMP": SMP.FIELDS,
    "EGNN": EGNN.FIELDS,
    "EGNNTorch": DenseEGNN.FIELDS,
    "SAN": SAN.FIELDS,
    "BYOLwrapper": BYOLWrapper.FIELDS,
}

# JAX fields the port's classes lack, with the JAX default they run at
UNPORTED_FIELDS: Dict[str, Dict[str, Any]] = {
    "PNA": {"pairwise_distances": False},
}

def get_model_class(name: str) -> type:
    name = MODEL_ALIASES.get(name, name)
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"model_type '{name}' is not ported yet (ROADMAP queue 1, "
            f"item {NOT_PORTED[name]}); ported: {sorted(MODEL_REGISTRY)}")
    if name not in MODEL_REGISTRY:
        raise KeyError(f"unknown model_type '{name}'; known: "
                       f"{sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[name]


def adapt_model_params(name: str, mp: Mapping[str, Any]) -> Dict[str, Any]:
    """`mp` restricted to the JAX class's fields; raises on a field the
    port lacks when it is set to other than the JAX default."""
    get_model_class(name)
    name = MODEL_ALIASES.get(name, name)
    out = {k: v for k, v in dict(mp).items() if k in JAX_FIELDS[name]}
    for field, default in UNPORTED_FIELDS.get(name, {}).items():
        if out.pop(field, default) != default:
            raise NotImplementedError(
                f"{name}.{field}={mp[field]!r} is not ported yet (ROADMAP "
                f"queue 1, item 7)")
    return out


def build_model(name: str, mp: Mapping[str, Any]) -> nn.Module:
    """The port's module for config name `name` and `model_parameters`
    `mp` (unknown keys dropped by `adapt_model_params`)."""
    cls = get_model_class(name)
    kw = adapt_model_params(name, mp)
    if cls is OptimalTransportModel:
        return cls.from_config(kw)
    return cls(**kw)

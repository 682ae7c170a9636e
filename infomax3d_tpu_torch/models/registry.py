"""Model registry (port of `infomax3d_tpu/models/registry.py`): the
`model_type` names of the configs mapped to the port's classes.

Each entry keeps the JAX class's field names (`JAX_FIELDS`): a config key
that is not a field is dropped, as the JAX package's `_adapt_model_params`
drops it.  `Net3D` is the
flat 3D network on CSR complete graphs; the CLI swaps it for the
parameter-compatible `Net3DDense` when `_dense_3d` is on, as the JAX
package does.  `Net3DVAE` names `Net3DAE` (`MODEL_ALIASES`, the JAX
table: the reference's configs name a class that exists nowhere).  The OT
generator's backbones (`gnn_model`: `PNAGNNRandom`, `GeomolGNNOGBFeat`
and the others) are in `optimal_transport.BACKBONES`, each class with its
JAX fields as `FIELDS`; `PNAGNN` and `PNAGNNRandomEdgeUpdate` are
registered as models too, as in JAX.  `BasicCritic` names `Critic`.  Every
name the JAX package registers is here; any other name raises
`KeyError`, as the JAX registry does.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

from torch import nn

from infomax3d_tpu_torch.models.byol import BYOLWrapper, Critic
from infomax3d_tpu_torch.models.egnn import EGNN
from infomax3d_tpu_torch.models.egnn_dense import DenseEGNN
from infomax3d_tpu_torch.models.geomol_mpnn import (
    GeomolGNNWrapper, GeomolGNNWrapperOGBFeat, GeomolGNNWrapperOGBFeatRandom,
    GeomolGNNWrapperOGBFeatRandomNonShared)
from infomax3d_tpu_torch.models.gin import OGBGNN
from infomax3d_tpu_torch.models.net3d import Net3D, Net3DDense
from infomax3d_tpu_torch.models.net3d_vae import (Net3DAE,
                                                  Net3DDistancePredictor)
from infomax3d_tpu_torch.models.optimal_transport import OptimalTransportModel
from infomax3d_tpu_torch.models.pna import PNA, PNAGNN
from infomax3d_tpu_torch.models.pna_random import PNARandom
from infomax3d_tpu_torch.models.pna_original import (PNAOriginal,
                                                     PNAOriginalSimple)
from infomax3d_tpu_torch.models.random_variants import (
    OGBGNNRandom, PNAGNNRandomEdgeUpdate, PNAOriginalRandom,
    PNAOriginalSimpleRandom, PNARandomEdgeUpdate)
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
    "BYOLwrapper": BYOLWrapper, "PNAGNN": PNAGNN, "PNARandom": PNARandom,
    "PNARandomEdgeUpdate": PNARandomEdgeUpdate,
    "PNAGNNRandomEdgeUpdate": PNAGNNRandomEdgeUpdate,
    "GeomolGNNWrapper": GeomolGNNWrapper,
    "GeomolGNNWrapperOGBFeatRandom": GeomolGNNWrapperOGBFeatRandom,
    "GeomolGNNWrapperOGBFeatRandomNonShared":
        GeomolGNNWrapperOGBFeatRandomNonShared,
    "Critic": Critic}

# reference YAML names whose class the reference cannot resolve, mapped
# onto the class the config means (the JAX package's models/registry.py
# and models/__init__.py)
MODEL_ALIASES: Dict[str, str] = {"Net3DVAE": "Net3DAE",
                                 "BasicCritic": "Critic"}

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
    "PNAGNN": PNAGNN.FIELDS,
    "PNARandom": PNARandom.FIELDS,
    "PNARandomEdgeUpdate": PNARandomEdgeUpdate.FIELDS,
    "PNAGNNRandomEdgeUpdate": PNAGNNRandomEdgeUpdate.FIELDS,
    "GeomolGNNWrapper": GeomolGNNWrapper.FIELDS,
    "GeomolGNNWrapperOGBFeatRandom": GeomolGNNWrapperOGBFeatRandom.FIELDS,
    "GeomolGNNWrapperOGBFeatRandomNonShared":
        GeomolGNNWrapperOGBFeatRandomNonShared.FIELDS,
    "Critic": Critic.FIELDS,
}

def get_model_class(name: str) -> type:
    name = MODEL_ALIASES.get(name, name)
    if name not in MODEL_REGISTRY:
        raise KeyError(f"unknown model_type '{name}'; known: "
                       f"{sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[name]


def adapt_model_params(name: str, mp: Mapping[str, Any]) -> Dict[str, Any]:
    """`mp` restricted to the JAX class's fields."""
    get_model_class(name)
    name = MODEL_ALIASES.get(name, name)
    return {k: v for k, v in dict(mp).items() if k in JAX_FIELDS[name]}


def build_model(name: str, mp: Mapping[str, Any], **extra) -> nn.Module:
    """The port's module for config name `name` and `model_parameters`
    `mp` (unknown keys dropped by `adapt_model_params`); `extra` are
    constructor arguments that are no JAX field (the critic's `in_dim`,
    which flax infers at init)."""
    cls = get_model_class(name)
    kw = adapt_model_params(name, mp)
    if cls is OptimalTransportModel:
        return cls.from_config(kw)
    return cls(**kw, **extra)

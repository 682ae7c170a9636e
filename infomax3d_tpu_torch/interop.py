"""Parameters between the JAX package's flax trees and the port's modules
(the name table of `infomax3d_tpu/train/torch_interop.py`).

`params_from_jax` turns the flax `params` / `batch_stats` trees (nested
dicts of numpy arrays) into a state_dict in the reference repository's
names, which the port's modules use — ``load_state_dict(strict=True)``
takes it:

==========================  ===========================================
flax component              torch component
==========================  ===========================================
``mp_{i}``                  ``mp_layers.{i}``
``FCLayer_{i}``             ``fully_connected.{i}``
``conv_{i}``                ``convs.{i}`` (OGBGNN)
``batch_norm_{i}``          ``batch_norms.{i}`` (OGBGNN; a bare BatchNorm)
``Dense_0/kernel``          ``linear.weight`` (transposed to [out, in])
``Dense_0/bias``            ``linear.bias``
``MaskedBatchNorm_0``       ``batch_norm`` (scale -> weight, mean / var
                            -> running_mean / running_var)
``conv_{i}/Dense_0``,       ``convs.{i}.mlp.0``, ``.mlp.1``, ``.mlp.3``
``MaskedBatchNorm_0``,      (a GINConv's Sequential(Linear, BatchNorm1d,
``Dense_1``                 ReLU, Linear))
``node_gnn/Dense_{2k+j}``,  ``node_gnn.mlp_virtualnode_list.{k}.{0|3}``,
``MaskedBatchNorm_{2k+j}``  ``.{1|4}`` (OGBGNN's virtual node:
                            Sequential(Linear, BN, ReLU, Linear, BN, ReLU))
``Dense_0``,                ``pool.gate_nn.0``, ``.1``, ``.3`` (OGBGNN's
``MaskedBatchNorm_0``,      attention pooling at the tree's root:
``Dense_1`` (the root's)    Sequential(Linear, BN, ReLU, Linear))
``<name>/encoder/emb_{i}``  ``<name>.<kind>_embedding_list.{i}.weight``
                            (kind "atom" where a component of the path
                            contains "atom", else "bond", as the JAX
                            package's `convert_state_dict` reads it)
``<dense>/kernel``          ``<dense>.weight`` (a bare Dense, transposed)
``root_emb``,               ``root_emb.weight``,
``virtualnode_embedding``   ``virtualnode_embedding.weight`` ([1, D]:
                            an ``nn.Embedding(1, D)``)
``node_embedding``, ``eps``, the same name (a bare parameter)
``edge_eps``, ``node_eps``,
``edge_eps_{d}``,
``node_eps_{d}``, ``v_node``,
``dist_emb_freq``
==========================  ===========================================

``Dense_0`` and ``MaskedBatchNorm_0`` become ``linear`` and ``batch_norm``
only inside an ``FCLayer_{i}``.  Where the reference's names are not in
that table, the port's modules carry flax's own submodule names, which
therefore pass through unchanged: the OT model's ``gnn``, ``gnn2``,
``encoder`` (``self_attn/in_proj``, ``out_proj``, ``norm1``, ``linear1``,
``linear2``, ``norm2``; a LayerNorm's ``scale`` -> ``weight``),
``coord_pred``, ``d_mlp``, ``h_mol_mlp``, ``alpha_mlp``, ``c_mlp`` and the
backbone's ``node_init`` / ``edge_init`` (GeoMol MLPs whose Linears are
``Dense_{k}``), and the edge-update layer's ``edge``, ``node_in``,
``node_out``, ``pretrans``, ``posttrans_1``, ``posttrans_2``; the OT
model's ``gnn_output_mlp`` / ``gnn2_output_mlp``, the GIN backbone's
``node_gnn``, ``bn_{i}``, ``vn_mlp_{i}_0`` / ``vn_mlp_{i}_1``,
``vn_bn_{i}``, the GeoMol MPNN's ``gnn``, ``node_init``, ``edge_init``,
``edge_model[_{d}]``, ``node_model[_{d}]``, ``mlp``, ``node_mlp_1`` /
``node_mlp_2``; the distance predictors' ``transformer_layer``,
``node_projection_net``, ``distance_net`` and ``predictor``,
Net3DAE's ``enc_{i}``, ``dec_{i}``, ``node_wise_encoder`` and ``net``,
OGBGNN's ``set2set/lstm_{i}/{ii,if,ig,io,hi,hf,hg,ho}`` (the reference
has no Set2Set), and the transformers, a JAX redesign: ``pna_{i}``,
``attn_{i}``, ``combine_{i}``, ``output``, and ``node_gnn``'s
``pos_enc_mlp`` and ``v_node`` (its blocks ``mp_{i}`` are
``mp_layers.{i}``, as the table maps them); PNAOriginal's
``embedding_h``, ``embedding_e``, ``layer_{i}``, ``tower_{t}``,
``pretrans``, ``posttrans``, ``mixing_network``, ``gru/{ir,iz,in,hr,hz,
hn}`` (flax's GRU cell: no bias on ``hr`` and ``hz``) and ``output/
Dense_{l}`` (`MLPReadout`), PNAOriginalSimpleRandom's ``node_init``, and
SMP's ``init_e`` (``emb``, ``lin_rbf_0``, ``lin``, ``lin_rbf_1``),
``init_v`` / ``update_v_{l}`` (``lin_up``, ``lins_{k}``, ``lin``),
``update_e_{l}`` (``lin_ji`` ... ``lin_rbf``, ``res_before_{b}`` /
``res_after_{a}`` with ``lin1``, ``lin2``); EGNN's ``input``,
``message_network``, ``soft_edge_network``, ``update_network``,
``node_wise_output_network``; the dense EGNN's ``embedding``,
``gcl_{i}/{edge_mlp_1, edge_mlp_2, att_mlp, coord_mlp_1, coord_mlp_out,
node_mlp_1, node_mlp_2}``, ``node_dec``, ``graph_dec``; SAN's ``gnn``
(``embedding_h``, ``linear_A``, ``PE_Transformer_{i}``, ``layer_{i}``
with ``attention/{Q, K, V, E, Q_2, K_2, E_2}``, ``O_h``, ``FFN_h_layer1``,
``FFN_h_layer2``, the bare BatchNorms ``batch_norm1_h`` / ``batch_norm2_h``
and LayerNorms ``layer_norm1_h`` / ``layer_norm2_h``; its edge encoders'
tables ``embedding_e_real/emb_{i}``, an encoder used on its own, keep the
bare name ``emb_{i}``); the BYOL wrapper's ``student`` (the wrapped
model's names below it, its root the student's) and ``predictor``.

`flax_paths` goes the other way for a port module's parameters: each torch
name's flax path, which the optimizer's group labels read.

`init_jax_variables` makes seeded numpy trees in the flax layout of a PNA,
Net3DDense, OGBGNN (each option), OGBGNNRandom, PNATransformer,
TransformerPlain, OptimalTransportModel (each backbone and option),
DistancePredictor, PNADistancePredictor, Net3DAE, Net3DDistancePredictor,
GeomolGNNWrapperOGBFeat, PNAOriginal (and its random alias),
PNAOriginalSimple, PNAOriginalSimpleRandom, SMP, EGNN, EGNNTorch, SAN
or BYOLwrapper (around any of these) configuration,
for serving and training without a checkpoint and for tests;
`load_variables` loads such trees into a module.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from infomax3d_tpu_torch.data.synthetic import (FULL_ATOM_FEATURE_DIMS,
                                                FULL_BOND_FEATURE_DIMS)


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _indexed(c: str, stem: str) -> bool:
    return c.startswith(stem) and c[len(stem):].isdigit()


# a GINConv's auto-named submodules are the reference's
# Sequential(Linear, BatchNorm1d, ReLU, Linear)
_GIN_MLP = {"Dense_0": "mlp.0", "MaskedBatchNorm_0": "mlp.1",
            "Dense_1": "mlp.3"}
_INDEXED = (("mp_", "mp_layers"), ("FCLayer_", "fully_connected"),
            ("conv_", "convs"), ("batch_norm_", "batch_norms"))


# OGBGNN's attention pooling: the root's auto-named gate
# Sequential(Linear, BatchNorm1d, ReLU, Linear)
_GATE = {"Dense_0": "pool.gate_nn.0", "MaskedBatchNorm_0": "pool.gate_nn.1",
         "Dense_1": "pool.gate_nn.3"}


def _virtual_mlp(c: str) -> str:
    """``Dense_{2k+j}`` / ``MaskedBatchNorm_{2k+j}`` of OGBGNN's node stack
    -> the reference's ``mlp_virtualnode_list.{k}.{0|3}`` / ``.{1|4}``."""
    stem, _, i = c.rpartition("_")
    k, j = divmod(int(i), 2)
    return f"mlp_virtualnode_list.{k}.{3 * j + (stem != 'Dense')}"


def _component(c: str, parent: str = "", root: bool = False) -> str:
    if _indexed(parent, "conv_") and c in _GIN_MLP:
        return _GIN_MLP[c]
    if root and c in _GATE:
        return _GATE[c]
    if parent == "node_gnn" and (_indexed(c, "Dense_")
                                 or _indexed(c, "MaskedBatchNorm_")):
        return _virtual_mlp(c)
    for stem, name in _INDEXED:
        if _indexed(c, stem):
            return f"{name}.{c[len(stem):]}"
    if _indexed(parent, "FCLayer_"):
        return {"Dense_0": "linear",
                "MaskedBatchNorm_0": "batch_norm"}.get(c, c)
    return c


def _components(mods) -> list:
    # a BYOL wrapper's ``student`` is transparent: the model's root is
    # the component below it
    root = 1 if tuple(mods[:1]) == ("student",) else 0
    return [_component(c, mods[i - 1] if i else "", i == root)
            for i, c in enumerate(mods)]


_LEAVES = {("params", "kernel"): "weight", ("params", "bias"): "bias",
           ("params", "scale"): "weight",
           ("batch_stats", "mean"): "running_mean",
           ("batch_stats", "var"): "running_var"}


# parameters that are leaves of their module, not of a Dense or BatchNorm
# (the GeoMol MPNN's per-depth epsilons carry a ``_{d}`` suffix)
_BARE = ("node_embedding", "eps", "edge_eps", "node_eps", "v_node",
         "dist_emb_freq")
# [D] parameters that the reference keeps as nn.Embedding(1, D) weights
_EMBEDDED = ("root_emb", "virtualnode_embedding")


def _bare(leaf: str) -> bool:
    stem, _, d = leaf.rpartition("_")
    return leaf in _BARE or (stem in ("edge_eps", "node_eps") and d.isdigit())


def _torch_name(collection: str, path: Tuple[str, ...]) -> str:
    *mods, leaf = path
    if collection == "params" and _bare(leaf):
        return ".".join(_components(mods) + [leaf])
    if collection == "params" and leaf in _EMBEDDED:
        return ".".join(_components(mods) + [leaf, "weight"])
    if leaf.startswith("emb_") and mods and mods[-1] == "encoder":
        # the JAX package's converter: "atom" where a component of the
        # path says so, else "bond" (PNAOriginal's embedding_h, SMP's emb)
        kind = "atom" if any("atom" in c for c in mods) else "bond"
        base = ".".join(_components(mods[:-1]))
        return f"{base}.{kind}_embedding_list.{leaf[4:]}.weight"
    if collection == "params" and _indexed(leaf, "emb_"):
        # a table of an encoder used on its own (SAN's edge encoders)
        return ".".join(_components(mods) + [leaf])
    if (collection, leaf) not in _LEAVES:
        raise KeyError(f"no torch name for {collection}/{'/'.join(path)}")
    return ".".join(_components(mods) + [_LEAVES[(collection, leaf)]])


def params_from_jax(params: Mapping, batch_stats: Mapping
                    ) -> Dict[str, torch.Tensor]:
    """Flax `params` / `batch_stats` trees (numpy leaves) -> a state_dict in
    the reference names; Dense kernels are transposed to [out, in] and every
    BatchNorm gets its `num_batches_tracked` (0).  Shapes are kept as they
    are: `load_state_dict(strict=True)` rejects any that differ."""
    sd: Dict[str, torch.Tensor] = {}
    for collection, tree in (("params", params), ("batch_stats", batch_stats)):
        for path, value in _flatten(tree):
            v = np.asarray(value, dtype=np.float32)
            if path[-1] == "kernel":
                v = v.T
            elif path[-1] in _EMBEDDED:
                v = v.reshape(1, -1)
            name = _torch_name(collection, path)
            sd[name] = torch.from_numpy(np.ascontiguousarray(v).copy())
            if collection == "batch_stats" and path[-1] == "mean":
                sd[name.rsplit(".", 1)[0] + ".num_batches_tracked"] = \
                    torch.tensor(0, dtype=torch.long)
    return sd


_FLAX_INDEXED = {name: stem for stem, name in _INDEXED}
_FLAX_GIN_MLP = {v.split(".")[1]: k for k, v in _GIN_MLP.items()}
_FLAX_GATE = {v.split(".")[2]: k for k, v in _GATE.items()}


def _flax_components(parts) -> list:
    """Torch module path components -> flax components (the inverse of
    `_components`, with ``<kind>_embedding_list.{i}`` -> ``encoder``,
    ``emb_{i}``)."""
    out, i = [], 0
    while i < len(parts):
        c, parent = parts[i], out[-1] if out else ""
        nxt = parts[i + 1] if i + 1 < len(parts) else ""
        if c in _FLAX_INDEXED and nxt.isdigit():
            out.append(f"{_FLAX_INDEXED[c]}{nxt}")
            i += 2
        elif _indexed(parent, "conv_") and c == "mlp" and nxt.isdigit():
            out.append(_FLAX_GIN_MLP[nxt])
            i += 2
        elif out in ([], ["student"]) and c == "pool" and nxt == "gate_nn":
            out.append(_FLAX_GATE[parts[i + 2]])
            i += 3
        elif c == "mlp_virtualnode_list" and nxt.isdigit():
            k, pos = int(nxt), int(parts[i + 2])
            stem = "Dense" if pos in (0, 3) else "MaskedBatchNorm"
            out.append(f"{stem}_{2 * k + (pos >= 3)}")
            i += 3
        elif _indexed(parent, "FCLayer_") and c in ("linear", "batch_norm"):
            out.append("Dense_0" if c == "linear" else "MaskedBatchNorm_0")
            i += 1
        elif c.endswith("_embedding_list") and nxt.isdigit():
            out += ["encoder", f"emb_{nxt}"]
            i += 2
        else:
            out.append(c)
            i += 1
    return out


def flax_paths(model: torch.nn.Module, running_stats: bool = False
               ) -> Dict[str, str]:
    """Each parameter's torch name -> its flax path, '/'-joined: a Linear's
    ``weight`` is ``kernel``, a BatchNorm's or LayerNorm's ``scale``, an
    embedding table is its ``emb_{i}`` leaf, a bare parameter keeps its
    name.  `params_from_jax` maps each such path back to the torch name.
    With `running_stats`, each BatchNorm's ``running_mean`` /
    ``running_var`` too, as the flax ``batch_stats`` paths ``.../mean`` /
    ``.../var``."""
    from infomax3d_tpu_torch.models.base import MaskedBatchNorm
    out: Dict[str, str] = {}
    for mod_name, mod in model.named_modules():
        parts = mod_name.split(".") if mod_name else []
        if running_stats and isinstance(mod, MaskedBatchNorm):
            for leaf, stat in (("running_mean", "mean"),
                               ("running_var", "var")):
                out[".".join(parts + [leaf])] = "/".join(
                    _flax_components(parts) + [stat])
        for leaf, _ in mod.named_parameters(recurse=False):
            comps = _flax_components(parts)
            if isinstance(mod, torch.nn.Embedding):
                path = comps
            elif isinstance(mod, torch.nn.Linear):
                path = comps + [{"weight": "kernel"}.get(leaf, leaf)]
            elif isinstance(mod, (MaskedBatchNorm, torch.nn.LayerNorm)):
                path = comps + [{"weight": "scale"}.get(leaf, leaf)]
            else:
                path = comps + [leaf]
            out[".".join(parts + [leaf])] = "/".join(path)
    return out


def load_variables(model: torch.nn.Module, variables: Mapping
                   ) -> torch.nn.Module:
    """`model` with the weights of flax numpy trees (`params`,
    `batch_stats`), loaded strictly."""
    model.load_state_dict(params_from_jax(variables["params"],
                                          variables.get("batch_stats", {})),
                          strict=True)
    return model


def _dense_tree(rng, fi, fo):
    bound = np.sqrt(6.0 / (fi + fo))
    return {"kernel": rng.uniform(-bound, bound, (fi, fo)),
            "bias": rng.normal(0.0, 0.1, fo)}


def _bn_tree(rng, d):
    params = {"scale": rng.uniform(0.5, 1.5, d),
              "bias": rng.normal(0.0, 0.1, d)}
    return params, {"mean": rng.normal(0.0, 0.2, d),
                    "var": rng.uniform(0.5, 2.0, d)}


def _mlp_tree(rng, in_dim, out_dim, layers, hidden, mid_bn, last_bn):
    # `layers` 0 is one layer, as in the modules
    dims = [in_dim] + [hidden] * (layers - 1) + [out_dim]
    n = len(dims) - 1
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for j in range(n):
        fo = dims[j + 1]
        p = {"Dense_0": _dense_tree(rng, dims[j], fo)}
        if (last_bn if j == n - 1 else mid_bn):
            p["MaskedBatchNorm_0"], bn_stats = _bn_tree(rng, fo)
            stats[f"FCLayer_{j}"] = {"MaskedBatchNorm_0": bn_stats}
        params[f"FCLayer_{j}"] = p
    return params, stats


def init_jax_variables(model_parameters: Mapping, seed: int = 0,
                       model_type: str = "PNA"):
    """Seeded numpy (params, batch_stats) trees in the flax layout of
    `PNA(**model_parameters)` (or of `Net3D` / `Net3DDense`, which share
    one layout, for `model_type` "Net3D" / "Net3DDense", of `OGBGNN`
    without a virtual node for "OGBGNN", of the OT model with the
    `PNAGNNRandomEdgeUpdate` backbone for "OptimalTransportModel", and of
    the distance predictors and `Net3DAE` / "Net3DVAE" for their names,
    and of the models of `_TABLE_INITS`: `PNAGNN`, the PNA random variants,
    the GeoMol wrappers and the critic, whose input width is `in_dim`):
    Xavier-uniform weights, small random
    biases, BatchNorm and LayerNorm scales in [0.5, 1.5] and non-trivial
    running statistics (so an eval forward exercises every fold), non-zero
    GIN `eps` and edge-update `edge_eps` / `node_eps`.  float32 leaves."""
    mp = dict(model_parameters)
    rng = np.random.default_rng(seed)
    model_type = {"Net3DVAE": "Net3DAE"}.get(model_type, model_type)
    if model_type in ("Net3D", "Net3DDense"):
        return _init_net3d_dense(mp, rng)
    if model_type == "OGBGNN":
        return _init_ogbgnn(mp, rng)
    if model_type == "OGBGNNRandom":
        return _init_ogbgnn_random(mp, rng)
    if model_type == "PNATransformer":
        return _init_pna_transformer(mp, rng)
    if model_type == "TransformerPlain":
        return _init_transformer_plain(mp, rng)
    if model_type == "OptimalTransportModel":
        return _init_optimal_transport(mp, rng)
    if model_type == "GeomolGNNWrapperOGBFeat":
        return _init_geomol_wrapper(mp, rng)
    if model_type in ("PNAOriginal", "PNAOriginalRandom"):
        return _init_pna_original(mp, rng)
    if model_type in ("PNAOriginalSimple", "PNAOriginalSimpleRandom"):
        return _init_pna_original_simple(mp, rng, model_type)
    if model_type == "SMP":
        return _init_smp(mp, rng)
    if model_type == "EGNN":
        return _init_egnn(mp, rng)
    if model_type == "EGNNTorch":
        return _init_egnn_dense(mp, rng)
    if model_type == "SAN":
        return _init_san(mp, rng)
    if model_type == "BYOLwrapper":
        return _init_byol(mp, seed)
    if model_type in _TABLE_INITS:
        return _TABLE_INITS[model_type](mp, rng)
    if model_type in _WRAPPED:
        key, inner, adapt = _WRAPPED[model_type]
        params, stats = init_jax_variables(adapt(mp), seed, inner)
        return {key: params}, ({key: stats} if stats else {})
    if model_type == "DistancePredictor":
        return _init_distance_predictor(mp, rng)
    if model_type == "Net3DAE":
        return _init_net3d_ae(mp, rng)
    if model_type != "PNA":
        raise ValueError(f"no numpy init for model_type {model_type!r}")
    d = mp["hidden_dim"]
    gnn, gnn_stats = _pnagnn_tree(mp, rng)
    out_p, out_s = _mlp_tree(
        rng, d * len(mp["readout_aggregators"]), mp["target_dim"],
        mp.get("readout_layers", 2), mp.get("readout_hidden_dim") or d,
        mp.get("readout_batchnorm", True), False)
    return (_f32({"node_gnn": gnn, "output": out_p}),
            _f32({"node_gnn": gnn_stats, "output": out_s}))


def _encoders(rng, d: int) -> Dict[str, Any]:
    return {"atom_encoder": {"encoder": _emb_tree(rng, FULL_ATOM_FEATURE_DIMS,
                                                  d)},
            "bond_encoder": {"encoder": _emb_tree(rng, FULL_BOND_FEATURE_DIMS,
                                                  d)}}


def _pna_layer_tree(rng, mp: Mapping[str, Any]):
    """One `PNALayer` of `mp`'s PNA fields: (params, batch_stats)."""
    d = mp["hidden_dim"]
    n_aggs = len(mp["aggregators"]) * len(mp["scalers"])
    bn = (mp.get("mid_batch_norm", False), mp.get("last_batch_norm", False))
    pre_p, pre_s = _mlp_tree(rng, 3 * d + bool(mp.get("pairwise_distances")),
                             d, mp.get("pretrans_layers", 1), d, *bn)
    post_p, post_s = _mlp_tree(rng, (n_aggs + 1) * d, d,
                               mp.get("posttrans_layers", 1), d, *bn)
    return ({"pretrans": pre_p, "posttrans": post_p},
            {"pretrans": pre_s, "posttrans": post_s})


def _pnagnn_tree(mp: Mapping[str, Any], rng, emb_dim: int = 0):
    """`PNAGNN(**mp)`'s (params, batch_stats); encoders of width `emb_dim`
    (default the hidden width)."""
    gnn = _encoders(rng, emb_dim or mp["hidden_dim"])
    gnn_stats: Dict[str, Any] = {}
    for i in range(mp.get("propagation_depth", 5)):
        gnn[f"mp_{i}"], gnn_stats[f"mp_{i}"] = _pna_layer_tree(rng, mp)
    return gnn, gnn_stats


def _transformer_block_tree(rng, d: int, ff: int) -> Dict[str, Any]:
    """A `TransformerEncoderBlock(d, heads, ff)`'s params."""
    return {"self_attn": {"in_proj": _dense_tree(rng, d, 3 * d),
                          "out_proj": _dense_tree(rng, d, d)},
            "norm1": _norm_tree(rng, d),
            "linear1": _dense_tree(rng, d, ff),
            "linear2": _dense_tree(rng, ff, d),
            "norm2": _norm_tree(rng, d)}


def _readout_tree(rng, mp: Mapping[str, Any], in_dim: int):
    """The readout MLP ``output`` of the supervised models."""
    return _mlp_tree(rng, in_dim, mp["target_dim"],
                     mp.get("readout_layers", 2),
                     mp.get("readout_hidden_dim") or mp["hidden_dim"],
                     mp.get("readout_batchnorm", True), False)


def _init_pna_transformer(mp: Dict[str, Any], rng):
    """`PNATransformer(**mp)`: the encoders, per layer ``pna_{i}``,
    ``attn_{i}`` and ``combine_{i}`` (one Linear [2D, D]), and
    ``output``."""
    d = mp["hidden_dim"]
    params, stats = _encoders(rng, d), {}
    for i in range(mp.get("propagation_depth", 5)):
        params[f"pna_{i}"], stats[f"pna_{i}"] = _pna_layer_tree(rng, mp)
        params[f"attn_{i}"] = _transformer_block_tree(
            rng, d, mp.get("dim_feedforward", 256))
        params[f"combine_{i}"] = _mlp_tree(rng, 2 * d, d, 1, d, False,
                                           False)[0]
    params["output"], stats["output"] = _readout_tree(
        rng, mp, d * len(mp.get("readout_aggregators", ("mean",))))
    return _f32(params), _f32(stats)


def _init_transformer_plain(mp: Dict[str, Any], rng):
    """`TransformerPlain(**mp)`: ``node_gnn`` (the atom encoder of width
    hidden - pos_enc_dim, ``pos_enc_mlp``, ``v_node``, ``mp_{i}``) and
    ``output``."""
    d, pe = mp["hidden_dim"], mp.get("pos_enc_dim", 16)
    gnn: Dict[str, Any] = {
        "atom_encoder": {"encoder": _emb_tree(rng, FULL_ATOM_FEATURE_DIMS,
                                              d - pe)},
        "pos_enc_mlp": _dense_tree(rng, 2, pe),
        "v_node": rng.normal(0.0, 1.0, d)}
    for i in range(mp.get("propagation_depth", 5)):
        gnn[f"mp_{i}"] = _transformer_block_tree(
            rng, d, mp.get("dim_feedforward", 256))
    out_p, out_s = _readout_tree(rng, mp, d)
    return (_f32({"node_gnn": gnn, "output": out_p}),
            _f32({"output": out_s}))


def _init_distance_predictor(mp: Dict[str, Any], rng):
    """`DistancePredictor(**mp)`: the PNA GNN, the transformer layer, the
    node projection or the distance net, as the JAX module creates
    them."""
    d = mp["pna_args"]["hidden_dim"]
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    params["node_gnn"], stats["node_gnn"] = _pnagnn_tree(mp["pna_args"], rng)
    if mp.get("transformer_layer", True):
        params["transformer_layer"] = _transformer_block_tree(
            rng, d, mp.get("dim_feedforward", 256))
    pdim, layers = mp.get("projection_dim", 3), mp.get("projection_layers", 1)
    if mp.get("distance_net", False):
        params["distance_net"], stats["distance_net"] = _mlp_tree(
            rng, 2 * d, mp.get("target_dim", 1), layers, pdim, True, False)
    elif pdim > 0:
        params["node_projection_net"], stats["node_projection_net"] = \
            _mlp_tree(rng, d, pdim, layers, 32, True, False)
    return _f32(params), _f32(stats)


def _net3d_layer_tree(rng, d: int, mp: Mapping[str, Any]):
    """One Net3D layer's (params, batch_stats)."""
    bn = mp.get("batch_norm", False)
    msg_p, msg_s = _mlp_tree(rng, 3 * d, d, mp.get("message_net_layers", 2),
                             d, bn, bn)
    bound = np.sqrt(6.0 / (d + 1))
    gate = {"kernel": rng.uniform(-bound, bound, (d, 1)),
            "bias": rng.normal(0.0, 0.1, 1)}
    upd_p, upd_s = _mlp_tree(rng, d, d, mp.get("update_net_layers", 2), d,
                             bn, bn)
    return ({"message_network": msg_p, "soft_edge_network": gate,
             "update_network": upd_p},
            {"message_network": msg_s, "update_network": upd_s})


def _init_net3d_ae(mp: Dict[str, Any], rng):
    """`Net3DAE(**mp)`: node embedding (or atom encoder), edge MLP, the
    encoder's and decoder's layers, the node-wise encoder, and the distance
    net or node projection, as the JAX module creates them."""
    d = mp["hidden_dim"]
    bn = mp.get("batch_norm", False)
    k = mp.get("fourier_encodings", 0)
    if mp.get("use_node_features", False):
        params: Dict[str, Any] = {"atom_encoder": {"encoder": _emb_tree(
            rng, FULL_ATOM_FEATURE_DIMS, d)}}
    else:
        params = {"node_embedding": rng.normal(0.0, 1.0, d)}
    stats: Dict[str, Any] = {}
    params["edge_input"], stats["edge_input"] = _mlp_tree(
        rng, 2 * k + 1 if k > 0 else 1, d, 1, d, bn, bn)
    depth = mp.get("encoder_depth", 4) or mp.get("propagation_depth", 0)
    for i in range(depth):
        params[f"enc_{i}"], stats[f"enc_{i}"] = _net3d_layer_tree(rng, d, mp)
    nwe = mp.get("node_wise_encoder_layers", 0)
    if nwe > 0:
        params["node_wise_encoder"], stats["node_wise_encoder"] = _mlp_tree(
            rng, d, d, nwe, d, bn, bn)
    for i in range(mp.get("decoder_depth", 4)):
        params[f"dec_{i}"], stats[f"dec_{i}"] = _net3d_layer_tree(rng, d, mp)
    pdim, layers = mp.get("projection_dim", 3), mp.get("projection_layers", 1)
    if mp.get("distance_net", True):
        params["distance_net"], stats["distance_net"] = _mlp_tree(
            rng, 2 * d, 1, layers, pdim, True, False)
    elif pdim > 0:
        params["node_projection_net"], stats["node_projection_net"] = \
            _mlp_tree(rng, d, pdim, layers, 32, True, False)
    return _f32(params), _f32(stats)


def _pna_distance_args(mp: Mapping[str, Any]) -> Dict[str, Any]:
    """`PNADistancePredictor`'s fields as its inner `DistancePredictor`'s
    arguments."""
    gnn = ("hidden_dim", "aggregators", "scalers", "residual",
           "mid_batch_norm", "last_batch_norm", "propagation_depth",
           "posttrans_layers", "pretrans_layers")
    return {"pna_args": {k: mp[k] for k in gnn if k in mp},
            "target_dim": mp.get("target_dim", 1), "distance_net": True,
            "projection_dim": mp.get("projection_dim", 3),
            "projection_layers": mp.get("projection_layers", 2),
            "transformer_layer": False}


def _net3d_distance_args(mp: Mapping[str, Any]) -> Dict[str, Any]:
    """`Net3DDistancePredictor`'s fields as its inner `Net3DAE`'s."""
    out = {k: v for k, v in mp.items() if k != "propagation_depth"}
    out.update(encoder_depth=mp.get("propagation_depth", 4),
               decoder_depth=mp.get("decoder_depth", 0))
    return out


# the wrappers: their subtree's name, the wrapped model and its arguments
_WRAPPED = {
    "PNADistancePredictor": ("predictor", "DistancePredictor",
                             _pna_distance_args),
    "Net3DDistancePredictor": ("net", "Net3DAE", _net3d_distance_args),
}


def _emb_tree(rng, dims, d):
    return {f"emb_{i}": rng.uniform(-1, 1, (v, d)) * np.sqrt(6.0 / (v + d))
            for i, v in enumerate(dims)}


def _init_ogbgnn(mp: Dict[str, Any], rng):
    """`OGBGNN(**mp)`: the JAX module's defaults (width 300, 5 layers, a
    virtual node, GIN, sum pooling) where the config is silent.  GIN
    convolutions get a non-zero `eps`, GCN ones a `root_emb`, the virtual
    node a non-zero embedding, so that each path shows in a test."""
    d, layers = mp.get("hidden_dim", 300), mp.get("num_layers", 5)
    gnn: Dict[str, Any] = {
        "atom_encoder": {"encoder": _emb_tree(rng, FULL_ATOM_FEATURE_DIMS, d)}}
    stats: Dict[str, Any] = {}
    for i in range(layers):
        if mp.get("gnn_type", "gin") == "gin":
            bn_p, bn_s = _bn_tree(rng, d)
            gnn[f"conv_{i}"] = {
                "bond_encoder": {"encoder": _emb_tree(
                    rng, FULL_BOND_FEATURE_DIMS, d)},
                "eps": rng.normal(0.0, 0.1, 1),
                "Dense_0": _dense_tree(rng, d, d), "MaskedBatchNorm_0": bn_p,
                "Dense_1": _dense_tree(rng, d, d)}
            stats[f"conv_{i}"] = {"MaskedBatchNorm_0": bn_s}
        else:
            gnn[f"conv_{i}"] = {
                "linear": _dense_tree(rng, d, d),
                "bond_encoder": {"encoder": _emb_tree(
                    rng, FULL_BOND_FEATURE_DIMS, d)},
                "root_emb": rng.normal(0.0, 1.0, d)}
        gnn[f"batch_norm_{i}"], stats[f"batch_norm_{i}"] = _bn_tree(rng, d)
    params: Dict[str, Any] = {"node_gnn": gnn}
    root_stats: Dict[str, Any] = {"node_gnn": stats}
    if mp.get("virtual_node", True):
        gnn["virtualnode_embedding"] = rng.normal(0.0, 0.1, d)
        for j in range(2 * (layers - 1)):
            gnn[f"Dense_{j}"] = _dense_tree(rng, d, d)
            gnn[f"MaskedBatchNorm_{j}"], stats[f"MaskedBatchNorm_{j}"] = \
                _bn_tree(rng, d)
    pooling, out_dim = mp.get("graph_pooling", "sum"), d
    if pooling == "attention":
        params["Dense_0"] = _dense_tree(rng, d, 2 * d)
        params["MaskedBatchNorm_0"], root_stats["MaskedBatchNorm_0"] = \
            _bn_tree(rng, 2 * d)
        params["Dense_1"] = _dense_tree(rng, 2 * d, 1)
    elif pooling == "set2set":
        params["set2set"] = {f"lstm_{k}": _lstm_tree(
            rng, 2 * d if k == 0 else d, d) for k in range(2)}
        out_dim = 2 * d
    params["graph_pred_linear"] = _dense_tree(rng, out_dim,
                                              mp.get("target_dim", 1))
    return _f32(params), _f32(root_stats)


def _lstm_tree(rng, in_dim: int, d: int) -> Dict[str, Any]:
    """A flax `LSTMCell(d)` on inputs of width `in_dim`: the input Denses
    without bias, the carry's with one."""
    out: Dict[str, Any] = {}
    for gate in ("i", "f", "g", "o"):
        out[f"i{gate}"] = {"kernel": _dense_tree(rng, in_dim, d)["kernel"]}
        out[f"h{gate}"] = _dense_tree(rng, d, d)
    return out


def _init_ogbgnn_random(mp: Dict[str, Any], rng):
    """`OGBGNNRandom(**mp)`: ``node_gnn`` (a `GNNNodeRandom`, with a
    virtual node unless the config says otherwise) and
    ``graph_pred_linear``."""
    gnn, stats = _init_gin_random(mp, rng, mp.get("virtual_node", True))
    gnn["graph_pred_linear"] = _dense_tree(rng, mp.get("hidden_dim", 300),
                                           mp.get("target_dim", 1))
    return _f32(gnn), _f32(stats)


def _geomol_mlp_tree(rng, in_dim, out_dim, num_layers):
    """A GeoMol MLP: `num_layers` hidden Denses of width in_dim when
    out_dim < 10, else out_dim, then the output Dense."""
    h = in_dim if out_dim < 10 else out_dim
    dims = [in_dim] + [h] * num_layers + [out_dim]
    return {f"Dense_{k}": _dense_tree(rng, dims[k], dims[k + 1])
            for k in range(num_layers + 1)}


def _norm_tree(rng, d):
    return {"scale": rng.uniform(0.5, 1.5, d), "bias": rng.normal(0.0, 0.1, d)}


def _init_edge_update_gnn(gp: Mapping, rng):
    """`PNAGNNRandomEdgeUpdate(**gp)`: (params, batch_stats)."""
    d, rvd = gp["hidden_dim"], gp["random_vec_dim"]
    parts = len(gp["aggregators"]) * (len(gp["scalers"])
                                      if len(gp["scalers"]) > 1 else 1)
    pre, post = gp.get("pretrans_layers", 1), gp.get("posttrans_layers", 1)
    bn = (gp.get("mid_batch_norm", False), gp.get("last_batch_norm", False))
    stats: Dict[str, Any] = {}
    gnn: Dict[str, Any] = {
        "atom_encoder": {"encoder": _emb_tree(rng, FULL_ATOM_FEATURE_DIMS,
                                              d)},
        "bond_encoder": {"encoder": _emb_tree(rng, FULL_BOND_FEATURE_DIMS,
                                              d)},
        "node_init": _geomol_mlp_tree(rng, d + rvd, d, 2),
        "edge_init": _geomol_mlp_tree(rng, d + rvd, d, 2)}
    for i in range(gp.get("propagation_depth", 5)):
        layer = {"edge": _dense_tree(rng, d, d),
                 "node_in": {"kernel": _dense_tree(rng, d, d)["kernel"]},
                 "node_out": {"kernel": _dense_tree(rng, d, d)["kernel"]}}
        layer_stats = {}
        for name, fi, n in (("pretrans", d, pre), ("posttrans_1", d, post),
                            ("posttrans_2", parts * d, post)):
            layer[name], layer_stats[name] = _mlp_tree(rng, fi, d, n, d, *bn)
            if name != "posttrans_2":
                eps = "edge_eps" if name == "pretrans" else "node_eps"
                layer[eps] = rng.normal(0.0, 0.1, 1)
        gnn[f"mp_{i}"], stats[f"mp_{i}"] = layer, layer_stats
    return gnn, stats


def _init_pna_random(gp: Mapping, rng):
    """`PNAGNNRandom(**gp)`: `PNAGNN`'s layout with encoders of width
    hidden - random_vec_dim."""
    return _pnagnn_tree(gp, rng, gp["hidden_dim"] - gp["random_vec_dim"])


def _init_gin_random(gp: Mapping, rng, virtual_node: bool = True):
    """`GINVirtualRandomBackbone(**gp)`: ``node_gnn``, a `GNNNodeRandom`
    with a virtual node (a non-zero ``virtualnode_embedding``, so that the
    virtual node's path shows in a test), or without one."""
    d, rvd = gp.get("hidden_dim", 300), gp.get("random_vec_dim", 10)
    layers = gp.get("num_layers", 5)
    node: Dict[str, Any] = {
        "atom_encoder": {"encoder": _emb_tree(rng, FULL_ATOM_FEATURE_DIMS,
                                              d - rvd)}}
    if virtual_node:
        node["virtualnode_embedding"] = rng.normal(0.0, 0.1, d)
    stats: Dict[str, Any] = {}
    for i in range(layers):
        bn_p, bn_s = _bn_tree(rng, d)
        node[f"conv_{i}"] = {
            "bond_encoder": {"encoder": _emb_tree(rng, FULL_BOND_FEATURE_DIMS,
                                                  d - rvd)},
            "eps": rng.normal(0.0, 0.1, 1),
            "Dense_0": _dense_tree(rng, d, d), "MaskedBatchNorm_0": bn_p,
            "Dense_1": _dense_tree(rng, d, d)}
        stats[f"conv_{i}"] = {"MaskedBatchNorm_0": bn_s}
        node[f"bn_{i}"], stats[f"bn_{i}"] = _bn_tree(rng, d)
        if virtual_node and i < layers - 1:
            node[f"vn_mlp_{i}_0"] = _dense_tree(rng, d, 2 * d)
            node[f"vn_bn_{i}"], stats[f"vn_bn_{i}"] = _bn_tree(rng, 2 * d)
            node[f"vn_mlp_{i}_1"] = _dense_tree(rng, 2 * d, d)
    return {"node_gnn": node}, {"node_gnn": stats}


def _geomol_gnn_tree(rng, node_dim, edge_dim, d, depth, n_layers,
                     non_shared=False):
    """`GeomolGNN(node_dim, edge_dim, d, depth, n_layers, non_shared)`
    (non-zero epsilons)."""
    gnn: Dict[str, Any] = {
        "node_init": _geomol_mlp_tree(rng, node_dim, d, n_layers),
        "edge_init": _geomol_mlp_tree(rng, edge_dim, d, n_layers)}
    for sfx in ([f"_{k}" for k in range(depth)] if non_shared else [""]):
        gnn[f"edge_model{sfx}"] = {
            "edge": _dense_tree(rng, d, d),
            "node_in": {"kernel": _dense_tree(rng, d, d)["kernel"]},
            "node_out": {"kernel": _dense_tree(rng, d, d)["kernel"]},
            "mlp": _geomol_mlp_tree(rng, d, d, n_layers)}
        gnn[f"node_model{sfx}"] = {
            "node_mlp_1": _geomol_mlp_tree(rng, d, d, n_layers),
            "node_mlp_2": _geomol_mlp_tree(rng, d, d, n_layers)}
        gnn[f"edge_eps{sfx}"] = rng.normal(0.0, 0.1, 1)
        gnn[f"node_eps{sfx}"] = rng.normal(0.0, 0.1, 1)
    return gnn


def _init_geomol_ogb(gp: Mapping, rng, noise: bool = False):
    """`GeomolGNNOGBFeat(**gp)`, or with `noise` `GeomolGNNOGBFeatRandom`:
    full-width encoders and ``gnn``; no BatchNorm."""
    d = gp.get("hidden_dim", 300)
    wide = d + (gp.get("random_vec_dim", 10) if noise else 0)
    return {"atom_encoder": {"encoder": _emb_tree(
                rng, FULL_ATOM_FEATURE_DIMS, d)},
            "bond_encoder": {"encoder": _emb_tree(
                rng, FULL_BOND_FEATURE_DIMS, d)},
            "gnn": _geomol_gnn_tree(rng, wide, wide, d, gp.get("depth", 3),
                                    gp.get("n_layers", 2),
                                    noise and gp.get("non_shared", False))}, {}


def _init_backbone(gnn_model: str, gp: Mapping, rng):
    if gnn_model == "PNAGNNRandomEdgeUpdate":
        return _init_edge_update_gnn(gp, rng)
    if gnn_model == "PNAGNNRandom":
        return _init_pna_random(gp, rng)
    if gnn_model == "GNN_node_VirtualnodeRandom":
        return _init_gin_random(gp, rng)
    if gnn_model == "GeomolGNNOGBFeat":
        return _init_geomol_ogb(gp, rng)
    if gnn_model.startswith("GeomolGNNOGBFeatRandom"):
        gp = dict(gp)
        gp.setdefault("non_shared", gnn_model.endswith("NonShared"))
        return _init_geomol_ogb(gp, rng, noise=True)
    raise ValueError(f"no numpy init for OT gnn_model {gnn_model!r}")


def _init_optimal_transport(mp: Dict[str, Any], rng):
    """`OptimalTransportModel(**mp)`: the backbone(s) of `gnn_model`, the
    output MLPs where the backbone's width differs from the model's, the
    neighbourhood transformer and the five GeoMol MLPs, with the JAX
    module's default layer counts where the hyperparameters are silent."""
    hp = mp["hyperparams"]
    gp = dict(mp["gnn_params"])
    gp.setdefault("random_vec_dim", hp["random_vec_dim"])
    H = hp["hidden_dim"]
    gnn_model = mp.get("gnn_model", "PNAGNNRandom")

    def layers(name, default):
        return hp.get(name, {}).get("n_layers", default)
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for key in ("gnn", "gnn2") if mp.get("use_two_gnns", True) else ("gnn",):
        params[key], stats[key] = _init_backbone(gnn_model, gp, rng)
    gd = gp.get("hidden_dim", 300)
    if gd != H:
        for key in ("gnn_output_mlp", "gnn2_output_mlp"):
            params[key] = _mlp_tree(rng, gd, H, 1, H, False, False)[0]
    if mp.get("use_transformer", True):
        params["encoder"] = {
            "self_attn": {"in_proj": _dense_tree(rng, 2 * H, 6 * H),
                          "out_proj": _dense_tree(rng, 2 * H, 2 * H)},
            "norm1": _norm_tree(rng, 2 * H),
            "linear1": _dense_tree(rng, 2 * H, 3 * H),
            "linear2": _dense_tree(rng, 3 * H, 2 * H),
            "norm2": _norm_tree(rng, 2 * H)}
    alpha_in = 3 * H + (hp["random_vec_dim"] if hp.get("random_alpha")
                        else 0)
    params.update(
        coord_pred=_geomol_mlp_tree(rng, 2 * H, 3, layers("coord_pred", 2)),
        d_mlp=_geomol_mlp_tree(rng, 2 * H, 1, layers("d_mlp", 1)),
        h_mol_mlp=_geomol_mlp_tree(rng, H, H, layers("h_mol_mlp", 1)),
        alpha_mlp=_geomol_mlp_tree(rng, alpha_in, 1, layers("alpha_mlp", 2)),
        c_mlp=_geomol_mlp_tree(rng, 4 * H, 1, layers("c_mlp", 1)))
    return _f32(params), _f32(stats)


def _init_geomol_wrapper(mp: Dict[str, Any], rng):
    """`GeomolGNNWrapperOGBFeat(**mp)`: ``node_gnn`` and the output MLP
    (mid BatchNorm per `readout_batchnorm`)."""
    d = mp["hidden_dim"]
    gnn, _ = _init_geomol_ogb(mp, rng)
    out_p, out_s = _mlp_tree(rng, d, mp.get("target_dim", 1),
                             mp.get("readout_layers", 2),
                             mp.get("readout_hidden_dim") or d,
                             mp.get("readout_batchnorm", True), False)
    return _f32({"node_gnn": gnn, "output": out_p}), _f32({"output": out_s})


def _readout_mlp(mp: Mapping[str, Any], rng, in_dim: int,
                 hidden_key: str = "readout_hidden_dim"):
    """The ``output`` MLP of a model with the readout fields."""
    d = mp["hidden_dim"]
    return _mlp_tree(rng, in_dim, mp.get("target_dim", 1),
                     mp.get("readout_layers", 2),
                     (mp.get(hidden_key) if hidden_key else None) or d,
                     mp.get("readout_batchnorm", True), False)


def _with_output(gnn_key: Optional[str], gnn, mp, rng, in_dim,
                 hidden_key: str = "readout_hidden_dim"):
    """(params, batch_stats) of a backbone tree `gnn` ((params, stats),
    under `gnn_key`, or at the root with None) and the ``output`` MLP."""
    out_p, out_s = _readout_mlp(mp, rng, in_dim, hidden_key)
    gp, gs = gnn
    params = dict(gp) if gnn_key is None else {gnn_key: gp}
    stats = dict(gs) if gnn_key is None else ({gnn_key: gs} if gs else {})
    params["output"] = out_p
    if out_s:
        stats["output"] = out_s
    return _f32(params), _f32(stats)


def _readout_width(mp: Mapping[str, Any]) -> int:
    return mp["hidden_dim"] * len(mp["readout_aggregators"])


def _random_gp(mp: Mapping[str, Any]) -> Dict[str, Any]:
    return dict({"random_vec_dim": 10}, **mp)


_TABLE_INITS = {
    "PNAGNN": lambda mp, rng: tuple(_f32(t) for t in _pnagnn_tree(mp, rng)),
    "PNARandom": lambda mp, rng: _with_output(
        "node_gnn", _init_pna_random(mp, rng), mp, rng, _readout_width(mp)),
    "PNAGNNRandomEdgeUpdate": lambda mp, rng: tuple(
        _f32(t) for t in _init_edge_update_gnn(_random_gp(mp), rng)),
    "PNARandomEdgeUpdate": lambda mp, rng: _with_output(
        None, _init_edge_update_gnn(_random_gp(mp), rng), mp, rng,
        _readout_width(mp)),
    "GeomolGNNWrapper": lambda mp, rng: _with_output(
        "gnn", (_geomol_gnn_tree(
            rng, mp["node_dim"] + mp.get("random_vec_dim", 10),
            mp["edge_dim"] + mp.get("random_vec_dim", 10), mp["hidden_dim"],
            mp.get("depth", 3), mp.get("n_layers", 2)), {}),
        mp, rng, mp["hidden_dim"], hidden_key=None),
    "GeomolGNNWrapperOGBFeatRandom": lambda mp, rng: _with_output(
        "node_gnn", _init_geomol_ogb(mp, rng, noise=True), mp, rng,
        mp["hidden_dim"]),
    "GeomolGNNWrapperOGBFeatRandomNonShared": lambda mp, rng: _with_output(
        "node_gnn", _init_geomol_ogb(dict(mp, non_shared=True), rng,
                                     noise=True), mp, rng, mp["hidden_dim"]),
    "Critic": lambda mp, rng: (_f32({"mlp": _mlp_tree(
        rng, mp.get("in_dim", 256),
        mp.get("metric_dim", 256) * mp.get("repeats", 4),
        mp.get("layers", 2), mp.get("hidden_dim", 256), False, False)[0]}),
        {}),
}
_TABLE_INITS["BasicCritic"] = _TABLE_INITS["Critic"]


_PNA_ORIGINAL_AGGS = ("mean", "max", "min", "std")
_PNA_ORIGINAL_SCALERS = ("identity", "amplification", "attenuation")


def _pna_original_parts(mp: Mapping[str, Any]) -> int:
    return (len(mp.get("aggregators", _PNA_ORIGINAL_AGGS))
            * len(mp.get("scalers", _PNA_ORIGINAL_SCALERS)))


def _init_pna_original(mp: Dict[str, Any], rng):
    """`PNAOriginal(**mp)`: ``embedding_h``, ``embedding_e`` (with
    `edge_feat`), ``gru`` (with `gru_enable`: flax's cell, no bias on
    ``hr`` / ``hz``), per layer ``tower_{t}`` (pretrans without
    BatchNorm, posttrans with the mid / last ones) and
    ``mixing_network``, and the `MLPReadout` ``output``."""
    d, towers = mp["hidden_dim"], mp.get("towers", 1)
    last_dim = mp["last_layer_dim"]
    e_dim = mp.get("edge_hidden_dim", 0) or d
    edge = mp.get("edge_feat", True)
    depth = mp.get("propagation_depth", 4)
    bn = (mp.get("mid_batch_norm", False), mp.get("last_batch_norm", False))
    params: Dict[str, Any] = {"embedding_h": {"encoder": _emb_tree(
        rng, FULL_ATOM_FEATURE_DIMS, d)}}
    stats: Dict[str, Any] = {}
    if edge:
        params["embedding_e"] = {"encoder": _emb_tree(
            rng, FULL_BOND_FEATURE_DIMS, e_dim)}
    if mp.get("gru_enable", False):
        params["gru"] = {g: (_dense_tree(rng, d, d) if g in ("ir", "iz",
                                                             "in", "hn")
                             else {"kernel": _dense_tree(rng, d, d)[
                                 "kernel"]})
                         for g in ("ir", "iz", "in", "hr", "hz", "hn")}
    for i in range(depth):
        last = i == depth - 1
        out = last_dim if last else d
        divide = mp.get("divide_input_last" if last else
                        "divide_input_first", True)
        w_in = d // towers if divide else d
        w_out = out // towers
        layer: Dict[str, Any] = {}
        layer_stats: Dict[str, Any] = {}
        for t in range(towers):
            pre, _ = _mlp_tree(
                rng, 2 * w_in + (e_dim if edge else 0)
                + int(mp.get("use_3d", False)), w_in,
                mp.get("pretrans_layers", 1), w_in, False, False)
            post, post_s = _mlp_tree(
                rng, (_pna_original_parts(mp) + 1) * w_in, w_out,
                mp.get("posttrans_layers", 1), w_out, *bn)
            layer[f"tower_{t}"] = {"pretrans": pre, "posttrans": post}
            layer_stats[f"tower_{t}"] = {"posttrans": post_s}
        layer["mixing_network"] = _dense_tree(rng, w_out * towers, out)
        params[f"layer_{i}"], stats[f"layer_{i}"] = layer, layer_stats
    width = last_dim * len(mp["readout_aggregators"])
    dims = [width, width // 2, width // 4, mp["target_dim"]]
    params["output"] = {f"Dense_{l}": _dense_tree(rng, dims[l], dims[l + 1])
                        for l in range(3)}
    return _f32(params), _f32(stats)


def _init_pna_original_simple(mp: Dict[str, Any], rng, model_type: str):
    """`PNAOriginalSimple(**mp)`: ``embedding_h``, per layer its
    posttrans MLP, and the output MLP; `PNAOriginalSimpleRandom` has
    ``atom_encoder`` and the 2-layer ``node_init`` in place of
    ``embedding_h``."""
    d, depth = mp["hidden_dim"], mp.get("propagation_depth", 4)
    bn = (mp.get("mid_batch_norm", False), mp.get("last_batch_norm", False))
    if model_type == "PNAOriginalSimpleRandom":
        rvd = mp.get("random_vec_dim", 10)
        params: Dict[str, Any] = {
            "atom_encoder": {"encoder": _emb_tree(rng, FULL_ATOM_FEATURE_DIMS,
                                                  d)},
            "node_init": _geomol_mlp_tree(rng, d + rvd, d, 2)}
    else:
        params = {"embedding_h": {"encoder": _emb_tree(
            rng, FULL_ATOM_FEATURE_DIMS, d)}}
    stats: Dict[str, Any] = {}
    for i in range(depth):
        out = mp["last_layer_dim"] if i == depth - 1 else d
        post, post_s = _mlp_tree(rng, _pna_original_parts(mp) * d, out,
                                 mp.get("posttrans_layers", 1), out, *bn)
        params[f"layer_{i}"] = {"posttrans": post}
        stats[f"layer_{i}"] = {"posttrans": post_s}
    params["output"], stats["output"] = _mlp_tree(
        rng, mp["last_layer_dim"] * len(mp["readout_aggregators"]),
        mp["target_dim"], mp.get("readout_layers", 2),
        mp.get("readout_hidden_dim") or d, mp.get("readout_batchnorm", True),
        False)
    return _f32(params), _f32(stats)


def _init_smp(mp: Dict[str, Any], rng):
    """`SMP(**mp)`: ``dist_emb_freq`` (pi, 2 pi, ... perturbed by 5 %),
    ``init_e``, ``init_v`` and per layer ``update_e_{l}`` /
    ``update_v_{l}``.  Every output Linear is drawn non-zero whatever
    `output_init` says (with zeros the model's output is 0 and a test of
    it holds nothing)."""
    h = mp.get("hidden_channels", 128)
    k, sph = mp.get("num_radial", 6), mp.get("num_spherical", 3)
    b, i_emb = mp.get("basis_emb_size", 8), mp.get("int_emb_size", 64)
    o, target = mp.get("out_emb_size", 256), mp.get("target_dim", 1)

    def dense(fi, fo, bias=True):
        t = _dense_tree(rng, fi, fo)
        return t if bias else {"kernel": t["kernel"]}

    def update_v():
        tree = {"lin_up": dense(h, o)}
        tree.update({f"lins_{j}": dense(o, o)
                     for j in range(mp.get("num_output_layers", 3))})
        tree["lin"] = dense(o, target, False)
        return tree

    def residual():
        return {"lin1": dense(h, h), "lin2": dense(h, h)}

    params: Dict[str, Any] = {"dist_emb_freq": np.arange(1, k + 1) * np.pi
                              * (1 + 0.05 * rng.normal(size=k))}
    init_e: Dict[str, Any] = {}
    if mp.get("use_node_features", True):
        init_e["emb"] = {"encoder": _emb_tree(rng, FULL_ATOM_FEATURE_DIMS, h)}
    else:
        init_e["node_embedding"] = rng.normal(0.0, 1.0, h)
    init_e.update(lin_rbf_0=dense(k, h), lin=dense(3 * h, h),
                  lin_rbf_1=dense(k, h, False))
    params["init_e"], params["init_v"] = init_e, update_v()
    for layer in range(mp.get("propagation_depth", 4)):
        e = {"lin_ji": dense(h, h), "lin_kj": dense(h, h),
             "lin_rbf1": dense(k, b, False), "lin_rbf2": dense(b, h, False),
             "lin_down": dense(h, i_emb, False),
             "lin_sbf1": dense(sph * k, b, False),
             "lin_sbf2": dense(b, i_emb, False),
             "lin_t1": dense(sph * sph * k, b, False),
             "lin_t2": dense(b, i_emb, False),
             "lin_up": dense(i_emb, h, False)}
        for j in range(mp.get("num_before_skip", 1)):
            e[f"res_before_{j}"] = residual()
        e["lin"] = dense(h, h)
        for j in range(mp.get("num_after_skip", 2)):
            e[f"res_after_{j}"] = residual()
        e["lin_rbf"] = dense(k, h, False)
        params[f"update_e_{layer}"] = e
        params[f"update_v_{layer}"] = update_v()
    return _f32(params), {}


def _init_net3d_dense(mp: Dict[str, Any], rng):
    d = mp["hidden_dim"]
    bn = mp.get("batch_norm", False)
    k = mp.get("fourier_encodings", 0)
    if mp.get("use_node_features", False):
        params: Dict[str, Any] = {"atom_encoder": {"encoder": _emb_tree(
            rng, FULL_ATOM_FEATURE_DIMS, d)}}
    else:
        params = {"node_embedding": rng.normal(0.0, 1.0, d)}
    stats: Dict[str, Any] = {}
    params["edge_input"], stats["edge_input"] = _mlp_tree(
        rng, 2 * k + 1 if k > 0 else 1, d, 1, d, bn, bn)
    for i in range(mp.get("propagation_depth", 4)):
        params[f"mp_{i}"], stats[f"mp_{i}"] = _net3d_layer_tree(rng, d, mp)
    nwo = mp.get("node_wise_output_layers", 2)
    if nwo > 0:
        (params["node_wise_output_network"],
         stats["node_wise_output_network"]) = _mlp_tree(rng, d, d, nwo, d,
                                                        bn, bn)
    params["output"], stats["output"] = _mlp_tree(
        rng, d * len(mp["readout_aggregators"]), mp["target_dim"],
        mp.get("readout_layers", 2), mp.get("readout_hidden_dim") or d,
        mp.get("readout_batchnorm", True), False)
    return _f32(params), _f32(stats)


def _init_egnn(mp: Dict[str, Any], rng):
    d = mp["hidden_dim"]
    bn = mp.get("batch_norm", False)
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    params["input"], stats["input"] = _mlp_tree(rng, mp["node_dim"], d, 1, d,
                                                bn, bn)
    for i in range(mp.get("propagation_depth", 4)):
        msg_p, msg_s = _mlp_tree(rng, 2 * d + 1, d, 2, d, bn, bn)
        upd_p, upd_s = _mlp_tree(rng, d, d, 2, d, bn, bn)
        params[f"mp_{i}"] = {"message_network": msg_p,
                             "soft_edge_network": _dense_tree(rng, d, 1),
                             "update_network": upd_p}
        stats[f"mp_{i}"] = {"message_network": msg_s,
                            "update_network": upd_s}
    (params["node_wise_output_network"],
     stats["node_wise_output_network"]) = _mlp_tree(rng, d, d, 2, d, bn, bn)
    params["output"], stats["output"] = _mlp_tree(
        rng, d * len(mp["readout_aggregators"]), mp["target_dim"],
        mp.get("readout_layers", 2), mp.get("readout_hidden_dim") or d,
        mp.get("readout_batchnorm", True), False)
    return _f32(params), _f32(stats)


def _init_egnn_dense(mp: Dict[str, Any], rng):
    d = mp["hidden_dim"]
    params: Dict[str, Any] = {"embedding": _dense_tree(rng, mp["in_node_nf"],
                                                       d)}
    for i in range(mp.get("n_layers", 4)):
        # the messages sum over every other atom: edge_mlp_2 scaled by
        # 1 / 20 keeps the aggregate O(1) at ~20 atoms, layer after layer
        edge_2 = _dense_tree(rng, d, d)
        edge_2["kernel"] = edge_2["kernel"] / 20.0
        layer = {"edge_mlp_1": _dense_tree(rng, 2 * d + 1, d),
                 "edge_mlp_2": edge_2,
                 "coord_mlp_1": _dense_tree(rng, d, d),
                 # the reference's coordinate head starts near zero
                 # (xavier gain 0.001): coordinates that move by O(1) per
                 # layer blow the squared distances up layer by layer
                 "coord_mlp_out": {"kernel": _dense_tree(rng, d, 1)["kernel"]
                                   * 1e-3},
                 "node_mlp_1": _dense_tree(rng, 2 * d, d),
                 "node_mlp_2": _dense_tree(rng, d, d)}
        if mp.get("attention", False):
            layer["att_mlp"] = _dense_tree(rng, d, 1)
        params[f"gcl_{i}"] = layer
    params["node_dec"] = _dense_tree(rng, d, d)
    params["graph_dec"] = _dense_tree(rng, d, mp["target_dim"])
    return _f32(params), {}


def _init_san(mp: Dict[str, Any], rng):
    hid = mp.get("GT_hidden_dim", 64)
    out_dim, lpe = mp["GT_out_dim"], mp.get("LPE_dim", 8)
    heads, layers = mp.get("GT_n_heads", 8), mp.get("GT_layers", 4)
    full, bn = mp.get("full_graph", True), mp.get("batch_norm", True)
    gnn: Dict[str, Any] = {
        "embedding_h": {"encoder": _emb_tree(rng, FULL_ATOM_FEATURE_DIMS,
                                             hid - lpe)},
        "embedding_e_real": _emb_tree(rng, FULL_BOND_FEATURE_DIMS, hid),
        "embedding_e_fake": _emb_tree(rng, FULL_BOND_FEATURE_DIMS, hid),
        "linear_A": _dense_tree(rng, 2, lpe)}
    gnn_stats: Dict[str, Any] = {}
    for i in range(mp.get("LPE_layers", 2)):
        gnn[f"PE_Transformer_{i}"] = _transformer_block_tree(rng, lpe, 2048)
    for i in range(layers):
        o = out_dim if i == layers - 1 else hid
        width = (o // heads) * heads
        names = ("Q", "K", "V", "E") + (("Q_2", "K_2", "E_2") if full
                                        else ())
        layer: Dict[str, Any] = {"attention": {
            n: {"kernel": _dense_tree(rng, hid, width)["kernel"]}
            for n in names}}
        layer["O_h"] = _dense_tree(rng, o, o)
        layer["FFN_h_layer1"] = _dense_tree(rng, o, 2 * o)
        layer["FFN_h_layer2"] = _dense_tree(rng, 2 * o, o)
        if mp.get("layer_norm", False):
            layer["layer_norm1_h"] = _norm_tree(rng, o)
            layer["layer_norm2_h"] = _norm_tree(rng, o)
        if bn:
            layer_stats = {}
            for k in ("batch_norm1_h", "batch_norm2_h"):
                layer[k], layer_stats[k] = _bn_tree(rng, o)
            gnn_stats[f"layer_{i}"] = layer_stats
        gnn[f"layer_{i}"] = layer
    out_p, out_s = _mlp_tree(
        rng, out_dim * len(mp["readout_aggregators"]), mp["target_dim"],
        mp.get("readout_layers", 2), mp["readout_hidden_dim"],
        mp.get("readout_batchnorm", True), False)
    return (_f32({"gnn": gnn, "output": out_p}),
            _f32({"gnn": gnn_stats, "output": out_s}))


def _init_byol(mp: Dict[str, Any], seed: int):
    """`BYOLWrapper(**mp)`: the student's trees (its `model_type`'s, from
    `seed`) under ``student`` and the predictor MLP's under
    ``predictor``."""
    inner = dict(mp["model_parameters"])
    params, stats = init_jax_variables(inner, seed, mp["model_type"])
    rng = np.random.default_rng((seed, 1))
    params, stats = {"student": params}, ({"student": stats} if stats
                                          else {})
    layers = mp.get("predictor_layers", 1)
    if layers > 0:
        pp, ps = _mlp_tree(rng, inner["target_dim"], mp.get("metric_dim", 256),
                           layers, mp.get("predictor_hidden_size", 256),
                           mp.get("predictor_batchnorm", False), False)
        params["predictor"] = _f32(pp)
        if _f32(ps):
            stats["predictor"] = _f32(ps)
    return params, stats


def _f32(tree: Mapping) -> Dict[str, Any]:
    """float32 leaves; sub-trees without leaves are dropped (flax has no
    `batch_stats` entry for a module without BatchNorm)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            v = _f32(v)
            if v:
                out[k] = v
        else:
            out[k] = np.asarray(v, np.float32)
    return out

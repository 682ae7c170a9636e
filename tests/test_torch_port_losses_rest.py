"""The rest of the JAX package's losses, the philosophy trainer's critic
and the registries, on the CPU against the JAX package: each loss's value
and its gradients with respect to every input (`CriticLoss`,
`BarlowTwinsLoss`, `RegularizationLoss`, `InfoNCE`, `InfoNCEHard`,
`NTXentHard`, `NTXentShuffled` and `SampleLossWrapper` given JAX's own
permutation and indices, `NTXentExtraNegatives`, `NTXentLocalGlobal`,
`NTXentGlobalLocal` on a batch with padding nodes, `JSELossGlobal`,
`JSELoss` in each of its modes, every divergence measure), the draws'
refusal without a key or generator, `Critic` (and its `BasicCritic`
alias) forward, the default critic loss (`MSELoss`) against a
reconstruction, and every name of the JAX model, loss and trainer
registries resolving in the port.

Tolerances, float32 on both sides: each value 1e-5 relative to JAX's,
each gradient 1e-5 of its own max; the critic's forward 1e-5 of the output's max.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infomax3d_tpu.losses import contrastive as jax_losses
from infomax3d_tpu.losses import get_loss as jax_get_loss
from infomax3d_tpu.models import MODEL_REGISTRY as JAX_MODELS
from infomax3d_tpu.models import get_model_class as jax_model_class
from infomax3d_tpu.train.trainer import TRAINER_REGISTRY as JAX_TRAINERS
from infomax3d_tpu_torch.interop import init_jax_variables, load_variables
from infomax3d_tpu_torch.losses import (LOSS_REGISTRY, SUPERVISED_LOSSES,
                                        get_loss)
from infomax3d_tpu_torch.losses import contrastive as port_losses
from infomax3d_tpu_torch.models.byol import Critic
from infomax3d_tpu_torch.models.registry import build_model, get_model_class
from infomax3d_tpu_torch.train.trainer import get_trainer_class
from test_torch_port_ot import _jax_tree, _rel

TOL = 1e-5
B, D, X, N, G = 6, 5, 2, 14, 4
RNG = np.random.default_rng(11)
Z1 = RNG.normal(size=(B, D)).astype(np.float32)
Z2 = RNG.normal(size=(B, D)).astype(np.float32)
# nodes of G graphs, two padding nodes (id G) at the end
NODE_GRAPH = np.array([0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 3, 3, 4, 4], np.int32)
NODE_MASK = NODE_GRAPH < G
ZN = RNG.normal(size=(N, D)).astype(np.float32)
ZG = RNG.normal(size=(G, D)).astype(np.float32)
NODES = dict(node_graph=NODE_GRAPH, node_mask=NODE_MASK)

# name: (constructor params, float inputs, other keyword arguments)
CASES = {
    "CriticLoss": ({}, (Z2, RNG.normal(size=(B, D, 3)).astype(np.float32)),
                   {}),
    "BarlowTwinsLoss": ({"lambd": 0.05}, (Z1, Z2), {}),
    "BarlowTwinsLoss_reg": ({"variance_reg": 0.5, "covariance_reg": 0.1,
                             "uniformity_reg": 0.2}, (Z1, Z2), {}),
    "RegularizationLoss": ({}, (Z1, Z2), {}),
    "InfoNCE": ({"tau": 0.3}, (Z1, Z2), {}),
    "InfoNCEHard": ({}, (Z1, Z2), {}),
    "InfoNCEHard_norm": ({"norm": True, "beta": 1.0}, (Z1, Z2), {}),
    "NTXentHard": ({"tau_plus": 0.05}, (Z1, Z2), {}),
    "NTXentExtraNegatives": (
        {"extra_negatives_weight": 0.7},
        (Z1, np.concatenate([Z2, RNG.normal(size=(B * X, D))]).astype(
            np.float32)), {}),
    "NTXentExtraNegatives_dot": (
        {"norm": False, "tau": 2.0},
        (Z1, np.concatenate([Z2, RNG.normal(size=(B * X, D))]).astype(
            np.float32)), {}),
    "NTXentLocalGlobal": ({"tau": 0.4}, (ZN, ZG), NODES),
    "NTXentLocalGlobal_unmasked": ({"norm": False}, (ZN[:12], ZG),
                                   {"node_graph": NODE_GRAPH[:12]}),
    "NTXentGlobalLocal": ({}, (ZG, ZN), NODES),
    "JSELossGlobal": ({}, (ZG, RNG.normal(size=(G, D)).astype(np.float32)),
                      {}),
}


def _jax_loss(name, params):
    return jax_get_loss(name.split("_")[0], **params)


def _port_loss(name, params):
    return get_loss(name.split("_")[0], **params)


def _hold(jax_fn, port_fn, inputs):
    """Value and every input's gradient of `port_fn` against `jax_fn`."""
    want, grads = jax.value_and_grad(
        jax_fn, tuple(range(len(inputs))))(*(jnp.asarray(x) for x in inputs))
    ts = [torch.tensor(x, requires_grad=True) for x in inputs]
    got = port_fn(*ts)
    got.backward()
    assert abs(got.item() - float(want)) <= TOL * abs(float(want)), \
        (got.item(), float(want))
    for t, g in zip(ts, grads):
        assert _rel(t.grad.numpy(), np.asarray(g)) <= TOL


@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_matches_jax(name):
    params, inputs, kw = CASES[name]
    jl, pl = _jax_loss(name, params), _port_loss(name, params)
    tkw = {k: torch.from_numpy(v) for k, v in kw.items()}
    _hold(lambda *z: jl(*z, **{k: jnp.asarray(v) for k, v in kw.items()}),
          lambda *z: pl(*z, **tkw), inputs)


def test_shuffled_and_sampled_losses_match_jax_given_its_draws():
    """`NTXentShuffled` with JAX's permutation and `SampleLossWrapper`
    (around NT-Xent) with JAX's indices, given to the port, against the
    JAX losses with the key that drew them."""
    key = jax.random.key(3)
    perm = np.array(jax.random.permutation(key, B))
    _hold(lambda a, b: jax_get_loss("NTXentShuffled", tau=0.3)(a, b,
                                                               key=key),
          lambda a, b: get_loss("NTXentShuffled", tau=0.3)(
              a, b, perm=torch.from_numpy(perm)), (Z1, Z2))
    wrapped = dict(loss_func="NTXent", fraction_samples=0.7, tau=0.2)
    idx = np.array(jax.random.randint(key, (int(B * 0.7),), 0, B))
    _hold(lambda a, b: jax_get_loss("SampleLossWrapper", **wrapped)(
        a, b, key=key),
          lambda a, b: get_loss("SampleLossWrapper", **wrapped)(
              a, b, idx=torch.from_numpy(idx)), (Z1, Z2))


def test_draws_need_a_key_or_generator():
    """Both packages' shuffled and sampled losses refuse to draw without
    their randomness (the JAX trainers pass no key, so a config naming
    them fails in either); the port draws from a generator it is
    given."""
    for name, kw in (("NTXentShuffled", {}),
                     ("SampleLossWrapper", {"loss_func": "NTXent",
                                            "fraction_samples": 0.5})):
        with pytest.raises(ValueError, match=name):
            jax_get_loss(name, **kw)(jnp.asarray(Z1), jnp.asarray(Z2))
        with pytest.raises(ValueError, match=name):
            get_loss(name, **kw)(torch.from_numpy(Z1), torch.from_numpy(Z2))
        gen = torch.Generator().manual_seed(0)
        got = get_loss(name, **kw)(torch.from_numpy(Z1),
                                   torch.from_numpy(Z2), generator=gen)
        assert torch.isfinite(got)


MEASURES = ("GAN", "JSD", "X2", "KL", "RKL", "DV", "H2", "W1")


@pytest.mark.parametrize("measure", MEASURES)
def test_divergence_measures_match_jax(measure):
    """Each measure's positive and negative expectations, averaged and
    not."""
    q = RNG.normal(size=(7, 3)).astype(np.float32)
    for fn in ("get_positive_expectation", "get_negative_expectation"):
        for average in (True, False):
            want = getattr(jax_losses, fn)(jnp.asarray(q), measure, average)
            got = getattr(port_losses, fn)(torch.from_numpy(q), measure,
                                           average)
            assert _rel(got.numpy(), np.asarray(want)) <= TOL, (fn, average)
    with pytest.raises(ValueError, match="measure"):
        port_losses.get_positive_expectation(torch.from_numpy(q), "nope")


def _views(n, width, rows):
    return [RNG.normal(size=(rows, width)).astype(np.float32)
            for _ in range(n)]


@pytest.mark.parametrize("mode", ["global_2", "global_3", "local_1",
                                  "local_2", "local_3"])
def test_jse_loss_modes_match_jax(mode):
    """`JSELoss` over global views (two, or three with `sigma` choosing
    two pairs) and local-global views (one, two, three)."""
    kind, n = mode.split("_")
    n = int(n)
    sigma = [[0, 1, 0], [1, 0, 1], [0, 1, 0]]
    zs = _views(n, D, G)
    zs_n = _views(n, D, N) if kind == "local" else []
    jl, pl = jax_get_loss("JSELoss"), get_loss("JSELoss")
    extra = dict(node_graph=NODE_GRAPH, node_mask=NODE_MASK, sigma=sigma)

    def split(args):
        return list(args[:n]), (list(args[n:]) if kind == "local" else None)

    def jfn(*args):
        a, b = split(args)
        return jl(a, b, **{k: (jnp.asarray(v) if k != "sigma" else v)
                           for k, v in extra.items()})

    def pfn(*args):
        a, b = split(args)
        return pl(a, b, **{k: (torch.from_numpy(v) if k != "sigma" else v)
                           for k, v in extra.items()})
    _hold(jfn, pfn, zs + zs_n)


# --- the critic ---------------------------------------------------------------

CRITIC = dict(metric_dim=4, hidden_dim=6, layers=2, repeats=3)


@pytest.mark.parametrize("name", ["Critic", "BasicCritic"])
def test_critic_forward_matches_jax(name):
    """The critic's [B, metric_dim, repeats] output against the JAX
    `Critic` from the same weights (input width `in_dim`, which flax
    infers at init); the JAX init's tree has the port's shapes."""
    assert get_model_class(name) is Critic
    params, _ = init_jax_variables(dict(CRITIC, in_dim=D), 2, name)
    jm = jax_model_class(name)(**CRITIC)
    shapes = jax.eval_shape(jm.init, jax.random.key(0), jnp.asarray(Z2))
    assert jax.tree_util.tree_map(np.shape, shapes["params"]) == \
        jax.tree_util.tree_map(np.shape, params)
    model = load_variables(build_model(name, CRITIC, in_dim=D),
                           {"params": params}).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(Z2)).numpy()
    want = np.asarray(jm.apply({"params": _jax_tree(params)},
                               jnp.asarray(Z2)))
    assert got.shape == want.shape == (B, 4, 3)
    assert _rel(got, want) <= TOL


def test_default_critic_loss_broadcasts_as_jax():
    """`MSELoss`, the default `critic_loss`, between a [B, D] embedding
    and a [B, D, R] reconstruction: both packages refuse shapes that do
    not broadcast, and agree where they do (B = D = R)."""
    jl, pl = jax_get_loss("MSELoss"), get_loss("MSELoss")
    recon = RNG.normal(size=(B, D, 3)).astype(np.float32)
    with pytest.raises(ValueError, match="broadcast"):
        jl(jnp.asarray(Z2), jnp.asarray(recon))
    with pytest.raises(RuntimeError, match="expanded size|must match"):
        pl(torch.from_numpy(Z2), torch.from_numpy(recon))
    z = RNG.normal(size=(3, 3)).astype(np.float32)
    r = RNG.normal(size=(3, 3, 3)).astype(np.float32)
    _hold(jl, pl, (z, r))


# --- the registries -----------------------------------------------------------

def test_jax_registries_resolve_in_the_port():
    """Every name of the JAX package's `MODEL_REGISTRY`, `LOSS_REGISTRY`
    and `TRAINER_REGISTRY` resolves in the port (no `KeyError`, no
    `NotImplementedError`)."""
    for name in JAX_MODELS:
        get_model_class(name)
    assert set(jax_losses.LOSS_REGISTRY) <= set(LOSS_REGISTRY) | set(
        SUPERVISED_LOSSES)
    for name in jax_losses.LOSS_REGISTRY:
        params = {"loss_func": "NTXent"} if name == "SampleLossWrapper" \
            else {}
        get_loss(name, **params)
    for name in JAX_TRAINERS:
        get_trainer_class(name)
    with pytest.raises(KeyError):
        get_loss("NoSuchLoss")

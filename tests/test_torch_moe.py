"""The port's MoE FFN (``models/moe.py``) against the JAX package's, from the
same numpy parameters and inputs, in float32.

  * ``_group_size`` and ``_capacity`` pinned against the reference's over
    lengths and capacity factors;
  * routing: the top-k expert ids **exactly** wherever the k-th and
    (k+1)-th router probabilities of a token are more than ``TIE`` apart;
    a token closer than that is counted and printed, with its margin, and
    its routing group is left out of the output comparison (a flip there
    moves which tokens the group's capacity drops);
  * ``moe_apply``'s output within 1e-5 and its aux losses within 1e-6 of
    the reference's, on Mixtral's smoke config, at a tiny capacity factor
    (most tokens dropped), with shared experts, and over several routing
    groups;
  * ``init_moe_layer`` draws the reference's shapes and distributions.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.models import moe as jmoe
from repro_torch.configs import get_smoke_config
from repro_torch.models import moe

torch.backends.cuda.matmul.allow_tf32 = False

ARCH = "mixtral-8x22b"
TIE = 1e-5
TOL = 1e-5


def _cfgs(**moe_kw):
    jcfg, tcfg = j_smoke(ARCH), get_smoke_config(ARCH)
    return (dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe,
                                                              **moe_kw)),
            dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe,
                                                              **moe_kw)))


def _params(jcfg, seed=0):
    """The reference's init, and the same leaves as torch tensors."""
    jp = jmoe.init_moe_layer(jax.random.PRNGKey(seed), jcfg)
    conv = lambda t: ({k: conv(v) for k, v in t.items()}
                      if isinstance(t, dict)
                      else torch.from_numpy(np.array(t)))
    return jp, conv(jp)


def _ref_routes(jp, x, jcfg):
    """The reference's routing (the first lines of its ``moe_apply``):
    expert ids and the float32 probabilities."""
    g = jmoe._group_size(x.shape[1])
    xg = jnp.asarray(x).reshape(-1, g, x.shape[-1])
    probs = jax.nn.softmax(jnp.einsum("ngd,de->nge", xg, jp["router"]), -1)
    _, idx = jax.lax.top_k(probs, jcfg.moe.top_k)
    return np.asarray(idx), np.asarray(probs)


@pytest.mark.parametrize("s", [1, 7, 64, 256, 1000, 2048, 2049, 4096, 8192,
                               6000])
@pytest.mark.parametrize("cf", [1.25, 0.05, 2.0])
def test_group_size_and_capacity_match_reference(s, cf):
    jcfg, tcfg = _cfgs(capacity_factor=cf)
    assert moe.GROUP_TOKENS == jmoe.GROUP_TOKENS
    g = moe._group_size(s)
    assert g == jmoe._group_size(s) and s % g == 0
    assert moe._capacity(g, tcfg) == jmoe._capacity(g, jcfg)


CASES = {
    "smoke": (dict(), (2, 256)),
    "tiny_capacity": (dict(capacity_factor=0.01), (2, 256)),
    "shared_experts": (dict(num_shared_experts=2), (2, 256)),
    "groups": (dict(top_k=3), (1, 4096 + 64)),
    "decode": (dict(), (5, 1)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_moe_apply_matches_reference(name):
    moe_kw, (b, s) = CASES[name]
    jcfg, tcfg = _cfgs(**moe_kw)
    jp, tp = _params(jcfg)
    x = np.random.default_rng(1).normal(
        size=(b, s, jcfg.d_model)).astype(np.float32)
    jy, jaux = jmoe.moe_apply(jp, jnp.asarray(x), jcfg)
    ty, taux = moe.moe_apply(tp, torch.from_numpy(x), tcfg)
    assert ty.shape == x.shape and ty.dtype == torch.float32

    # routes exactly away from near-ties
    jidx, probs = _ref_routes(jp, x, jcfg)
    g = moe._group_size(s)
    _, _, _, tidx = moe.route(tp, torch.from_numpy(x).reshape(-1, g,
                                                              x.shape[-1]),
                              tcfg)
    k = jcfg.moe.top_k
    srt = np.sort(probs, -1)[..., ::-1]
    margin = (srt[..., k - 1] - srt[..., k] if k < jcfg.moe.num_experts
              else np.full(srt.shape[:-1], np.inf))
    clear = margin > TIE
    np.testing.assert_array_equal(tidx.numpy()[clear], jidx[clear])
    near = np.argwhere(~clear)
    print(f"{name}: {len(near)} of {clear.size} tokens within {TIE} of a "
          f"routing tie; margins {margin[~clear].tolist()}")

    # outputs where no token of the routing group is near a tie
    groups = clear.all(-1)
    yj = np.asarray(jy).reshape(-1, g, x.shape[-1])
    yt = ty.numpy().reshape(-1, g, x.shape[-1])
    assert groups.any()
    np.testing.assert_allclose(yt[groups], yj[groups], atol=TOL, rtol=0)
    if groups.all():
        for a, c in zip(taux, jaux):
            np.testing.assert_allclose(a.numpy(), np.asarray(c), atol=1e-6,
                                       rtol=1e-6)
    if name == "tiny_capacity":
        cap = moe._capacity(g, tcfg)
        assert cap == k                 # max(int(g·k·0.01 / E), k)
        # most (token, choice) slots are dropped: few outputs are nonzero
        assert (np.abs(yt).sum(-1) > 0).mean() < 0.2


def test_moe_apply_keeps_the_activation_dtype():
    jcfg, tcfg = _cfgs()
    _, tp = _params(jcfg)
    tp = {k: (v.bfloat16() if isinstance(v, torch.Tensor) else v)
          for k, v in tp.items()}
    x = torch.randn(2, 128, tcfg.d_model,
                    generator=torch.Generator().manual_seed(0))
    y, aux = moe.moe_apply(tp, x.bfloat16(), tcfg)
    assert y.dtype == torch.bfloat16 and bool(torch.isfinite(y).all())
    assert aux.expert_load.shape == (tcfg.moe.num_experts,)
    z = moe.MoEAux.zero(4)
    assert z.expert_load.shape == (4,) and float(z.load_balance_loss) == 0


@pytest.mark.parametrize("shared", [0, 1])
def test_init_moe_layer_matches_reference_distributions(shared):
    jcfg, tcfg = _cfgs(num_shared_experts=shared)
    jp, _ = _params(jcfg)
    flat = {"router": jp["router"], "w_gate": jp["w_gate"],
            "w_up": jp["w_up"], "w_down": jp["w_down"]}
    if shared:
        flat.update({f"shared::{k}": v for k, v in jp["shared"].items()})
    tp = moe.init_moe_layer(tcfg, torch.Generator().manual_seed(0),
                            device="cpu")
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: tuple(v.shape) for k, v in flat.items()}
    assert tp.keys() == moe.moe_leaf_shapes(tcfg).keys()
    for name, t in tp.items():
        mats = t if name in moe.EXPERT_LEAVES else [t]
        for m in mats:
            fan_in = m.shape[0]
            assert float(m.abs().max()) <= 2.0 / fan_in ** 0.5 + 1e-6
            # truncated normal in [-2, 2] has std 0.8796
            assert abs(float(m.std()) * fan_in ** 0.5 - 0.8796) < 0.03

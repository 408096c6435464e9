"""The heads-sharded serve (A.12) on two gloo ranks on the CPU, against the
port's single-device path and the JAX package.

One ``(data 1, model 2)`` world of two ranks (``tests/torch_mesh_helpers.
py``, started once for the file through a ``file://`` store under
``tmp_path``, each rank on one intra-op thread) runs everything that needs
a process group; this process holds its results:

  * plans (llama3-8b-262k's smoke config at 8 query / 4 kv heads, a random
    dictionary): the plan every rank builds under the mesh equals the
    reference's global plan exactly, and the kv-head range of it that a
    rank's sharded decode reads equals the reference's per-shard
    ``build_decode_plan(kv_head_range=…)`` exactly, at full width and
    capped;
  * kernels: the sharded B.2 (output and Ã), B.3 and B.4 on their plain
    versions are bitwise the unsharded plain calls, and within the port's
    stated 1e-5 of the reference's Pallas kernels in interpret mode;
  * serves (the smoke config, 4/4 heads, 2 per rank): a batch serve and a
    paged scheduler serve with ``decode_sparse``, sharded, give every logit
    row bitwise the port's unsharded serve's, with the routing through the
    sharded prefill and decode counted, and tokens near-tie aware
    against the reference's serves; chunked admission is off under the
    mesh;
  * the launcher: ``--smoke --device cpu --model-parallel 2`` prints the
    tokens it prints without ``--model-parallel``.
"""
import dataclasses
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import _flatten
from repro.configs import get_smoke_config as j_smoke
from repro.core.pattern_dict import PivotalState as JState
from repro.kernels import decode_attn as jda
from repro.kernels.ops import batched_block_sparse_attention as j_b2
from repro.models.api import build_model as j_build
from repro.serving import EngineConfig as JConfig
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine
from repro.serving import decode_plan as jdplan
from repro_torch import checkpoint
from repro_torch.kernels.decode_attn import (DecodePlan, flash_decode_plan,
                                             flash_decode_plan_paged)
from repro_torch.kernels.indices import compact_block_mask
from repro_torch.kernels.ops import batched_block_sparse_attention
from repro_torch.launch.mesh import run_ranks

import torch_mesh_helpers as mh
from torch_serving_helpers import MarginRecorder

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ = 256                          # 4 blocks of 64
PLENS = (256, 230, 200)
NEWS = (6, 6)                      # the batch serve: the first two prompts
PAGED_NEWS = (4, 2, 3)             # the paged serve: slot refill on 2 slots
PLAN_PREFILL, PLAN_CACHE, PLAN_WIDTH = 256, 384, 3
KERNEL_TOL = 1e-5                  # plain versions against Pallas interpret
TIE_TOL = 1e-3                     # a token may flip only below this margin


def _kernel_inputs(rng):
    """B.2/B.3/B.4 operands at 8 query / 4 kv heads (G = 2), float32."""
    b, h, hkv, n, bs, d = 2, 8, 4, 256, 64, 64
    nbq = n // bs
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    masks = rng.random((b, h, nbq, nbq)) < 0.5
    masks |= np.eye(nbq, dtype=bool)
    masks &= np.tril(np.ones((nbq, nbq), bool))
    nb, s = 6, 6 * bs
    keep = rng.random((b, hkv, nb, h // hkv)) < 0.6
    keep[1, 2] = False                          # an empty row: zeros
    lens = np.array([s - 10, 5 * bs])
    valid = np.arange(s)[None, :] < lens[:, None]
    idx, cnt = compact_block_mask(torch.as_tensor(keep.any(-1)))
    ck, cv = f(b, hkv, s, d), f(b, hkv, s, d)
    pages = rng.permutation(b * nb) + 1          # page 0: the null page
    table = pages.reshape(b, nb).astype(np.int32)
    pool_k = np.zeros((b * nb + 1, hkv, bs, d), np.float32)
    pool_v = np.zeros_like(pool_k)
    for i in range(b):
        for j in range(nb):
            pool_k[table[i, j]] = ck[i, :, j * bs:(j + 1) * bs]
            pool_v[table[i, j]] = cv[i, :, j * bs:(j + 1) * bs]
    return dict(q=f(b, h, n, d), k=f(b, hkv, n, d), v=f(b, hkv, n, d),
                masks=masks, gate=(rng.random((b, h)) < 0.5).astype(np.int32),
                block_size=bs, dq=f(b, h, d), ck=ck, cv=cv, valid=valid,
                plan=(idx.numpy(), cnt.numpy(), keep), pool_k=pool_k,
                pool_v=pool_v, page_table=table)


def _torch(x):
    if isinstance(x, np.ndarray):
        return torch.as_tensor(x)
    if isinstance(x, (tuple, list)):
        return type(x)(_torch(v) for v in x)
    if isinstance(x, dict):
        return {k: _torch(v) for k, v in x.items()}
    return x


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    rng = np.random.default_rng(0)
    jcfg = j_smoke(mh.ARCH)
    jm = j_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tcfg = mh.get_smoke_config(mh.ARCH)
    params = checkpoint.params_from_numpy(_flatten(jp), tcfg, device="cpu")
    prompts = [rng.integers(0, jcfg.vocab_size, n).astype(np.int64)
               for n in PLENS]
    pcfg = mh.plan_config()
    c, nbp = pcfg.num_layers * pcfg.num_heads, PLAN_PREFILL // 64
    state = (rng.random((3, c, nbp, nbp)) < 0.4,
             rng.random((3, c, nbp)).astype(np.float32),
             rng.random((3, c)) < 0.7)
    kern = _kernel_inputs(rng)
    inp = dict(params=params, prompts=prompts, seq=SEQ, news=NEWS,
               paged_news=PAGED_NEWS, state=_torch(state),
               prefill_len=PLAN_PREFILL, cache_len=PLAN_CACHE,
               width=PLAN_WIDTH, kernels=_torch(kern))
    torch.save(inp, tmp / "in.pt")
    run_ranks(mh.rank_job, 2, (str(tmp / "in.pt"), str(tmp)),
              init_file=str(tmp / "store"), device="cpu", timeout_s=300)
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    return dict(jm=jm, jp=jp, jcfg=jcfg, prompts=prompts, state=state,
                kern=kern, ranks=ranks)


def _equal(a, b):
    """Bitwise equality of nested tensors (NaN-free)."""
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and a.shape == b.shape \
            and torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a == b


def test_ranks_lay_out_one_model_axis_and_agree(world):
    r0, r1 = world["ranks"]
    assert r0["mesh"] == ({"data": 1, "model": 2}, 0)
    assert r1["mesh"] == ({"data": 1, "model": 2}, 1)
    for part in ("kernels", "serves"):
        assert _equal(r0[part], r1[part]), part
    for name in ("global", "global_w"):
        assert _equal(r0["plans"][name], r1["plans"][name]), name


def _ref_plan_args(world):
    jm = j_build(dataclasses.replace(world["jcfg"], **mh.PLAN_HEADS))
    jsp = jm.default_share_prefill()
    tsp = mh.build_model(mh.plan_config(), device="cpu"
                         ).default_share_prefill()
    np.testing.assert_array_equal(np.asarray(jsp.cluster_ids),
                                  np.asarray(tsp.cluster_ids))
    st = JState(*(jnp.asarray(x) for x in world["state"]))
    return jsp, st, jm.cfg


def _assert_plan(got, ref):
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_plan_and_each_rank_s_range_equal_the_reference(world):
    jsp, st, cfg = _ref_plan_args(world)
    kw = dict(prefill_len=PLAN_PREFILL, cache_len=PLAN_CACHE)
    for key, width in (("", None), ("_w", PLAN_WIDTH)):
        glob = jdplan.build_decode_plan(jsp, st, cfg, width=width, **kw)
        for r, res in enumerate(world["ranks"]):
            _assert_plan(res["plans"]["global" + key], glob)
            shard = jdplan.build_decode_plan(
                jsp, st, cfg, width=width, kv_head_range=(2 * r, 2), **kw)
            _assert_plan(res["plans"]["slice" + key], shard)


def test_sharded_kernels_are_bitwise_the_unsharded_plain_calls(world):
    k = _torch(world["kern"])
    got = world["ranks"][0]["kernels"]
    out, a_tilde = batched_block_sparse_attention(
        k["q"], k["k"], k["v"], k["masks"], block_size=k["block_size"],
        stats_gate=k["gate"])
    assert torch.equal(got["b2"][0], out)
    assert torch.equal(got["b2"][1], a_tilde)
    plan = DecodePlan(*k["plan"])
    assert torch.equal(got["b3"], flash_decode_plan(
        k["dq"], k["ck"], k["cv"], plan, k["valid"], impl="kernel"))
    assert torch.equal(got["b4"], flash_decode_plan_paged(
        k["dq"], k["pool_k"], k["pool_v"], k["page_table"], plan,
        k["valid"], impl="kernel"))


def test_sharded_kernels_match_the_reference_pallas_kernels(world):
    k = world["kern"]
    got = world["ranks"][0]["kernels"]
    j = lambda x: jnp.asarray(x)
    jo, ja = j_b2(j(k["q"]), j(k["k"]), j(k["v"]), j(k["masks"]),
                  block_size=k["block_size"], interpret=True,
                  stats_gate=j(k["gate"]))
    np.testing.assert_allclose(got["b2"][0].numpy(), np.asarray(jo),
                               atol=KERNEL_TOL, rtol=0)
    ja, ta = np.asarray(ja), got["b2"][1].numpy()
    fin = np.isfinite(ja)
    np.testing.assert_array_equal(np.isfinite(ta), fin)
    np.testing.assert_allclose(ta[fin], ja[fin], atol=KERNEL_TOL, rtol=0)
    plan = jda.DecodePlan(*(j(x) for x in k["plan"]))
    ref = jda.flash_decode_plan(j(k["dq"]), j(k["ck"]), j(k["cv"]), plan,
                                j(k["valid"]), impl="kernel", interpret=True)
    np.testing.assert_allclose(got["b3"].numpy(), np.asarray(ref),
                               atol=KERNEL_TOL, rtol=0)
    ref = jda.flash_decode_plan_paged(
        j(k["dq"]), j(k["pool_k"]), j(k["pool_v"]), j(k["page_table"]),
        plan, j(k["valid"]), impl="kernel", interpret=True)
    np.testing.assert_allclose(got["b4"].numpy(), np.asarray(ref),
                               atol=KERNEL_TOL, rtol=0)


@pytest.mark.parametrize("name", ["batch", "paged"])
def test_sharded_serve_is_bitwise_the_unsharded_serve(world, name):
    serves = world["ranks"][0]["serves"]
    plain, mesh = serves[name], serves[name + "_mesh"]
    assert plain["tokens"] == mesh["tokens"]
    assert plain["reasons"] == mesh["reasons"]
    assert len(plain["logits"]) == len(mesh["logits"]) > 1
    for a, b in zip(plain["logits"], mesh["logits"]):
        assert torch.equal(a, b)
    assert not plain["calls"]                    # no mesh, no shard call
    if name == "paged":
        assert mesh["pool"]["pages_in_use_at_end"] == 0


def test_sharded_serves_route_through_the_sharded_paths(world):
    serves = world["ranks"][0]["serves"]
    layers, heads = 2, 4
    half = heads // 2
    # batch: one prefill launch a layer, one decode a layer and step
    assert serves["batch_mesh"]["calls"] == {
        ("prefill", half, heads): layers,
        ("decode", half, heads): layers * (NEWS[0] - 1)}
    # paged: a prefill per admission, the paged decode only
    calls = serves["paged_mesh"]["calls"]
    assert calls[("prefill", half, heads)] == layers * len(PAGED_NEWS)
    assert calls[("decode_paged", half, heads)] >= layers
    assert set(calls) == {("prefill", half, heads),
                          ("decode_paged", half, heads)}
    assert serves["chunk_tokens"] == (64, 0)      # chunking off under mesh


def _near_tie(ref_tokens, got_tokens, margin_at):
    for uid, (a, b) in enumerate(zip(ref_tokens, got_tokens)):
        flip = next((t for t, (x, y) in enumerate(zip(a, b)) if x != y),
                    None)
        if flip is None:
            assert len(a) == len(b), uid
            continue
        m = margin_at(uid, flip)
        print(f"request {uid}: flip at token {flip}, margin {m}")
        assert m is not None and m < TIE_TOL, (uid, flip, m)


def test_sharded_serves_match_the_reference_serves(world):
    jm, jp = world["jm"], world["jp"]
    serves = world["ranks"][0]["serves"]
    base = dict(method="share", attn_impl="sparse", decode_sparse=True,
                seq_buckets=(SEQ,), max_batch=2)
    jeng = JEngine(jm, jp, jm.default_share_prefill(), JConfig(**base))
    jreqs = [JRequest(uid=i, prompt=p.astype(np.int32), max_new_tokens=m)
             for i, (p, m) in enumerate(zip(world["prompts"], NEWS))]
    jeng.serve(jreqs)
    # the batch path has no logit hook: a flip's margin is read from the
    # port's unsharded serve, whose rows agree with the reference's to
    # ~1e-5 up to the first flip (both condition on the same tokens)
    rows = serves["batch"]["logits"]

    def batch_margin(uid, t):
        top2 = np.sort(rows[t][uid].numpy())[-2:]
        return float(top2[1] - top2[0])

    _near_tie([r.output_tokens.tolist() for r in jreqs],
              serves["batch_mesh"]["tokens"], batch_margin)

    rec = MarginRecorder()
    jeng = JEngine(jm, jp, jm.default_share_prefill(),
                   JConfig(**base, paged=True))
    jreqs = [JRequest(uid=i, prompt=p.astype(np.int32), max_new_tokens=m)
             for i, (p, m) in enumerate(zip(world["prompts"], PAGED_NEWS))]
    jeng.serve(jreqs, faults=rec)
    _near_tie([r.output_tokens.tolist() for r in jreqs],
              serves["paged_mesh"]["tokens"],
              lambda uid, t: rec.margins.get((uid, t)))


def _untimed(line):
    """A launcher request line without its times and rates."""
    line = re.sub(r"\b(queue|ttft|prefill|decode)=[0-9.]+s", r"\1=", line)
    return re.sub(r"\([0-9.]+ tok/s, ", "(", line)


def test_launcher_model_parallel_prints_the_unsharded_tokens():
    """Both launcher runs at once (one ``PYTHONHASHSEED``: the retrieval
    prompts hash the task's name); their request lines are equal but for
    their times (tokens, finish reasons, plan shares, pattern stats)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               PYTHONHASHSEED="0", OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           mh.ARCH, "--smoke", "--decode-sparse", "--device", "cpu",
           "--prompt-len", str(SEQ), "--num-requests", "2"]
    procs = [subprocess.Popen(cmd + extra, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env,
                              cwd=ROOT)
             for extra in ([], ["--model-parallel", "2"])]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=240)
        finally:
            p.kill()
        assert p.returncode == 0, err[-3000:]
        toks = [_untimed(line) for line in out.splitlines()
                if line.startswith("req ")]
        assert len(toks) == 2 and all("out=[" in t for t in toks), out
        outs.append((toks, out))
    (plain, _), (sharded, out) = outs
    assert "serving under mesh {'data': 1, 'model': 2}" in out
    assert sharded == plain

"""The port's launch layer (A.13) against the JAX package's: the registry's
pairs, the sparse-decode helpers, ``model_flops`` and the roofline terms
exactly; ``shard()``'s placements against the reference's spec logic on
fake worlds; the step bundles' argument shapes against the reference's
avals and their values against the reference's bundles; the dry-run's
accounting.

Fake worlds (:func:`repro_torch.launch.mesh.fake_world`) are ``"fake"``
process groups in this process: nothing is allocated and no collective
moves data.  Each test enters and leaves its own, so no group outlives it.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

import repro.configs as jconfigs
from repro.checkpoint.checkpointer import _flatten
from repro.distributed import sharding as jsh
from repro.launch import hlo_analysis as jha
from repro.launch import steps as jsteps
from repro.serving import sparse_decode as jsd
from repro_torch import checkpoint
from repro_torch import configs
from repro_torch import tree as tu
from repro_torch.distributed import param_specs as tps
from repro_torch.distributed import sharding as tsh
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import step_analysis as sa
from repro_torch.launch import steps
from repro_torch.serving import sparse_decode as tsd

from torch_serving_helpers import one_torch_thread  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False


def _ref_dryrun():
    """The reference's dry-run module.  Importing it appends a device-count
    flag to ``XLA_FLAGS`` for later processes: the backend is locked first
    (as the reference's own test does) and the variable restored."""
    jax.devices()
    before = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as jdryrun
    if before is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = before
    return jdryrun


# --------------------------------------------------------------------------
# Registry, simple functions
# --------------------------------------------------------------------------

def test_registry_pairs_names_and_shapes_equal_the_reference():
    assert list(configs.ASSIGNED) == list(jconfigs.ASSIGNED)
    assert list(configs.PAPER_MODELS) == list(jconfigs.PAPER_MODELS)
    assert list(configs.REGISTRY) == list(jconfigs.REGISTRY)
    assert len(configs.REGISTRY) == 12
    assert configs.SKIP_PAIRS == jconfigs.SKIP_PAIRS
    for paper in (False, True):
        assert configs.list_archs(paper) == jconfigs.list_archs(paper)
        assert list(configs.dryrun_pairs(paper)) == \
            list(jconfigs.dryrun_pairs(paper))
    assert len(list(configs.dryrun_pairs())) == 39
    assert len(list(configs.dryrun_pairs(True))) == 47
    for name in configs.INPUT_SHAPES:
        assert dataclasses.asdict(configs.get_shape(name)) == \
            dataclasses.asdict(jconfigs.get_shape(name))
    with pytest.raises(KeyError, match="unknown shape"):
        configs.get_shape("decode_1m")


def test_model_flops_equal_the_reference_for_every_pair():
    jdryrun = _ref_dryrun()
    for arch, shape in configs.dryrun_pairs(True):
        assert dryrun.model_flops(arch, shape) == \
            jdryrun.model_flops(arch, shape), (arch, shape)


def test_roofline_terms_equal_the_reference():
    # the reference test's inputs, and a second set with every category
    cases = [(1e12, 1e9, {"all-reduce": {"count": 1, "bytes": 1e9}}, 4),
             (3e15, 7e11, {op: {"count": i + 1, "bytes": 1e8 * (i + 1)}
                           for i, op in enumerate(sa.COLLECTIVE_OPS)}, 256)]
    for flops, nb, coll, chips in cases:
        for peaks in ((197e12, 819e9, 50e9), (mesh_lib.PEAK_FLOPS_BF16,
                                              mesh_lib.HBM_BW,
                                              mesh_lib.LINK_BW)):
            ref = jha.roofline_terms(flops=flops, bytes_accessed=nb,
                                     coll=coll, chips=chips,
                                     peak_flops=peaks[0], hbm_bw=peaks[1],
                                     ici_bw=peaks[2])
            mine = sa.roofline_terms(flops=flops, bytes_accessed=nb,
                                     coll=coll, chips=chips,
                                     peak_flops=peaks[0], hbm_bw=peaks[1],
                                     link_bw=peaks[2])
            assert mine == ref
            assert sa.dominant_term(mine) == jha.dominant_term(ref)
    assert sa.COLLECTIVE_OPS == jha.COLLECTIVE_OPS
    # the card's data-sheet constants
    assert (mesh_lib.PEAK_FLOPS_BF16, mesh_lib.HBM_BW, mesh_lib.LINK_BW) == (
        989e12, 3.35e12, 450e9)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sparse_decode_helpers_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    nb, bs = int(rng.integers(3, 9)), int(rng.choice([16, 64]))
    keep = rng.random((2, 3, 4, nb)) < 0.4
    for cache_len, prefill_len in ((nb * bs, nb * bs - 5),
                                   (nb * bs + 37, nb * bs)):
        ref = np.asarray(jsd.keep_blocks_to_token_mask(
            jnp.asarray(keep), bs, cache_len, prefill_len))
        mine = tsd.keep_blocks_to_token_mask(torch.from_numpy(keep), bs,
                                             cache_len, prefill_len)
        assert mine.dtype == torch.bool
        np.testing.assert_array_equal(mine.numpy(), ref)
    assert tsd.decode_traffic_fraction(torch.from_numpy(keep)) == \
        jsd.decode_traffic_fraction(jnp.asarray(keep))


# --------------------------------------------------------------------------
# shard() placements on fake worlds
# --------------------------------------------------------------------------

# every distinct (shape, logical axes) of the 24 sites in the reference's
# models, at shapes whose dimensions divide and do not divide the axes
SITES = [
    ((8, 32, 64, 128), ("batch", "heads")),            # q, attention out
    ((8, 8, 64, 128), ("batch", "kv_heads")),           # k, v
    ((8, 12, 64, 128), ("batch", "heads")),             # heads not dividing
    ((8, 64, 448), ("batch", None, "mlp")),             # the MLP hidden
    ((32, 8, 8, 256, 128), ("batch", "kv_heads", "seq", "heads")),
    ((8, 8, 4096, 128), ("batch", "kv_heads", "seq", "heads")),  # cache
    ((1, 8, 4096, 128), ("batch", "kv_heads", "seq", "heads")),  # batch 1
    ((40, 8, 16, 128), (None, "kv_heads", None, "heads")),       # the pool
    ((8, 4096, 512), ("batch", "seq")),                 # MLA's latent cache
    ((1, 4096, 512), ("batch", "seq")),
    ((8, 32, 256), ("experts", "batch")),               # MoE expert inputs
    ((8, 8, 32, 256), ("experts", "batch", None, "mlp")),
    ((8, 64, 256), ("batch", None, "ssm_inner")),       # RG-LRU, SSM
    ((8, 64, 16, 64), ("batch", None, "ssm_inner")),
    ((8, 64, 32000), ("batch", None, "vocab")),         # the logits
    ((8, 64, 256), ("batch",)),                         # the residual stream
    ((4, 64, 256), ("batch",)),
]
WORLDS = [((4, 4), ("data", "model")), ((2, 16, 16), ("pod", "data", "model"))]


class _StubMesh:
    def __init__(self, mesh):
        self.axis_names, self.shape = mesh.axis_names, dict(mesh.shape)


def _ref_spec(mesh, shape, logical, monkeypatch):
    """The reference's ``shard`` spec, read off its sharding constraint."""
    monkeypatch.setattr(jsh, "NamedSharding", lambda m, spec: spec)
    monkeypatch.setattr(jsh.jax.lax, "with_sharding_constraint",
                        lambda x, spec: spec)
    with jsh.use_rules(jsh.ShardingRules(_StubMesh(mesh))):
        return jsh.shard(jax.ShapeDtypeStruct(shape, jnp.float32), *logical)


@pytest.mark.parametrize("world", WORLDS, ids=["4x4", "2x16x16"])
def test_shard_places_dtensors_as_the_reference_specs(world, monkeypatch):
    shape_w, axes = world
    with mesh_lib.fake_world(int(np.prod(shape_w))):
        mesh = mesh_lib.make_test_mesh(shape_w, axes)
        rules = tsh.ShardingRules(mesh)
        for shape, logical in SITES:
            spec = _ref_spec(mesh, shape, logical, monkeypatch)
            assert tuple(tsh.shard_spec(rules, shape, logical)) == \
                tuple(spec)
            want = tps.placements(spec, mesh)
            x = distribute_tensor(torch.empty(shape, device="meta"),
                                  mesh.device_mesh,
                                  [Replicate()] * len(axes),
                                  src_data_rank=None)
            plain = torch.empty(shape, device="meta")
            with tsh.use_rules(rules):
                got = tsh.shard(x, *logical)
                assert tsh.shard(plain, *logical) is plain
            assert tuple(got.placements) == want, (shape, logical)
            assert tsh.shard(x, *logical) is x          # no rules: identity
    assert not dist.is_initialized()


def test_fake_world_refuses_a_second_group_and_cleans_up():
    with mesh_lib.fake_world(4):
        with pytest.raises(RuntimeError, match="exists"):
            with mesh_lib.fake_world(4):
                pass
        assert dist.get_world_size() == 4
    assert not dist.is_initialized()


def test_a_known_redistribute_is_one_all_gather():
    with mesh_lib.fake_world(4):
        mesh = mesh_lib.make_test_mesh((2, 2))
        x = distribute_tensor(torch.empty(8, 6, device="meta"),
                              mesh.device_mesh, [Shard(0), Replicate()],
                              src_data_rank=None)
        with sa.StepCounter((x,)) as c:
            y = x.redistribute(mesh.device_mesh, [Replicate(), Replicate()])
    assert c.collectives["all-gather"] == {"count": 1, "bytes": 8 * 6 * 4}
    assert sum(v["count"] for v in c.collectives.values()) == 1
    assert c.output_bytes(y) == 8 * 6 * 4 and c.temp_bytes(y) == 0


def test_counter_flops_equal_flop_counter_mode():
    from torch.utils.flop_counter import FlopCounterMode
    a, b = torch.randn(16, 32), torch.randn(32, 8)

    def step():
        return torch.softmax(a @ b, -1) @ torch.randn(8, 4)
    with sa.StepCounter((a, b)) as c:
        step()
    with FlopCounterMode(display=False) as f:
        step()
    assert c.flops == f.get_total_flops() == 2 * 16 * 32 * 8 + 2 * 16 * 8 * 4


# --------------------------------------------------------------------------
# Step bundles
# --------------------------------------------------------------------------

def _ref_keys(path):
    return "::".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path)


def _ref_leaves(args):
    return {_ref_keys(p): (tuple(x.shape), jnp.dtype(x.dtype).name)
            for p, x in jax.tree_util.tree_flatten_with_path(args)[0]}


def _port_leaves(args):
    return {k: (tuple(x.shape), str(x.dtype).replace("torch.", ""))
            for k, x in tu.flatten_with_path(args)}


def _smoke(monkeypatch, seq, batch):
    """Both packages' ``steps`` on smoke configs and a (seq, batch) shape
    of each kind."""
    for mod, cfgs in ((jsteps, jconfigs), (steps, configs)):
        monkeypatch.setattr(mod, "get_config", cfgs.get_smoke_config)
        monkeypatch.setattr(mod, "get_shape", lambda n, c=cfgs: dataclasses
                            .replace(c.get_shape(n), seq_len=seq,
                                     global_batch=batch))


# each family's kinds at full size (dense: every shape; moe, vlm, MLA, ssm,
# hybrid and encdec two kinds each), within the tests' time budget
PAIRS = [("llama3-8b-262k", "train_4k"), ("llama3-8b-262k", "prefill_32k"),
         ("llama3-8b-262k", "decode_32k"), ("llama3-8b-262k", "long_500k"),
         ("mixtral-8x22b", "train_4k"), ("mixtral-8x22b", "decode_32k"),
         ("qwen2-vl-72b", "prefill_32k"), ("qwen2-vl-72b", "decode_32k"),
         ("deepseek-v2-236b", "prefill_32k"),
         ("deepseek-v2-236b", "decode_32k"),
         ("mamba2-370m", "train_4k"), ("mamba2-370m", "long_500k"),
         ("recurrentgemma-9b", "prefill_32k"),
         ("recurrentgemma-9b", "long_500k"),
         ("whisper-base", "train_4k"), ("whisper-base", "decode_32k")]


@pytest.mark.parametrize("arch,shape", PAIRS,
                         ids=[f"{a}-{s}" for a, s in PAIRS])
def test_bundle_args_equal_the_reference_avals(arch, shape):
    jb = jsteps.build_step(arch, shape, jax.make_mesh((1, 1),
                                                      ("data", "model")))
    with mesh_lib.fake_world(1):
        tb = steps.build_step(arch, shape, mesh_lib.make_test_mesh((1, 1)))
    assert tb.name == jb.name
    assert tb.cfg == tb.model.cfg
    assert dataclasses.asdict(tb.cfg) == dataclasses.asdict(jb.cfg)
    if jb.name.endswith("/decode"):
        # the caches' containers differ (the port keeps the dense cache as
        # its (k, v) pair): their leaves in order
        ref_cache = [(tuple(x.shape), jnp.dtype(x.dtype).name)
                     for x in jax.tree.leaves(jb.args[2])]
        port_cache = list(_port_leaves(tb.args[2]).values())
        assert port_cache == ref_cache
        ref = _ref_leaves(jb.args[:2] + jb.args[3:])
        port = _port_leaves(tb.args[:2] + tb.args[3:])
        # the write slot: the cache's last
        assert int(tb.args[3]) == configs.get_shape(shape).seq_len - 1
    else:
        ref, port = _ref_leaves(jb.args), _port_leaves(tb.args)
    assert port == ref


def _numpy_args(jargs, seed):
    """Values for the reference's arguments: its own where it has them
    (parameters), else seeded draws (tokens in the vocabulary, caches)."""
    rng = np.random.default_rng(seed)

    def leaf(x):
        if isinstance(x, jax.ShapeDtypeStruct):
            if jnp.issubdtype(x.dtype, jnp.integer):
                return rng.integers(0, 64, x.shape).astype(x.dtype)
            return (rng.standard_normal(x.shape) * 0.5).astype(x.dtype)
        return np.asarray(x)
    return jax.tree.map(leaf, jargs)


@pytest.fixture
def gloo_world(tmp_path):
    """A gloo world of one rank on the CPU, for the time of a test."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        yield mesh_lib.make_test_mesh((1, 1))
    finally:
        dist.destroy_process_group()


# the bundles' values on plain tensors against the reference's bundles:
# logits and caches within these (float32, TF32 off; the port's prefill
# runs the sparse path's plain B.1/B.2, the reference's its chunked path,
# on the same masks)
LOGIT_ATOL = 1e-4
LOSS_RTOL = 1e-5
# AdamW's first step: an element whose first moment is below SMALL of its
# leaf's max divides a near-zero gradient by itself and may move up to one
# step (lr) apart; every other element within PARAM_ATOL
PARAM_ATOL = 1e-5
SMALL = 1e-4


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k", "train_4k"])
def test_bundle_values_equal_the_reference_bundles(shape, monkeypatch,
                                                   gloo_world,
                                                   one_torch_thread):
    _smoke(monkeypatch, 256, 2)
    arch = "granite-3-2b"
    # Auto axes: the reference's sharding constraints refuse JAX's default
    # Explicit axes (its own mesh tests fail on that)
    jmesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(
        jax.sharding.AxisType.Auto,) * 2)
    jb = jsteps.build_step(arch, shape, jmesh, dtype=jnp.float32)
    tb = steps.build_step(arch, shape, gloo_world, dtype=torch.float32)
    jargs = list(jb.args)
    jargs[0] = jb.model.init(jax.random.PRNGKey(0))
    if jb.name.endswith("/train"):
        from repro.optim import init_adamw
        jargs[1] = init_adamw(jargs[0])
    jargs = _numpy_args(tuple(jargs), seed=3)
    if jb.name.endswith("/decode"):
        jargs = jargs[:3] + (np.int32(255),) + jargs[4:]
    # the port's arguments from the reference's values, by key (the dense
    # cache by leaf order)
    flat = dict(_flatten(jargs))
    cache = [np.asarray(x) for x in jax.tree.leaves(jargs[2])] \
        if jb.name.endswith("/decode") else None

    def make(key, shape_, dtype):
        if cache is not None and key.startswith("2::"):
            arr = cache[int(key.split("::")[-1])]
        else:
            arr = flat[key]
        assert arr.shape == shape_, key
        return torch.from_numpy(np.array(arr)).to(dtype)
    targs = steps.plain_args(tb, make)

    jout = jax.jit(jb.fn)(*jax.tree.map(jnp.asarray, jargs))
    tout = tb.fn(*targs)
    if jb.name.endswith("/prefill"):
        np.testing.assert_allclose(tout.last_logits.numpy(),
                                   np.asarray(jout.last_logits),
                                   rtol=0, atol=LOGIT_ATOL)
        ref_cache = jax.tree.leaves(jout.cache)
        for got, want in zip(tu.leaves(tout.cache), ref_cache):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=LOGIT_ATOL)
    elif jb.name.endswith("/decode"):
        np.testing.assert_allclose(tout[0].numpy(), np.asarray(jout[0]),
                                   rtol=0, atol=LOGIT_ATOL)
        for got, want in zip(tu.leaves(tout[1]), jax.tree.leaves(jout[1])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=LOGIT_ATOL)
    else:
        jp, jopt, jm = jout
        tp, topt, tm = tout
        for k in ("total_loss", "ce_loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=LOSS_RTOL)
        mu = dict(_flatten(jopt.mu))
        for key, want in _flatten(jp).items():
            got = dict(tu.flatten_with_path(tp))[key].numpy()
            small = np.abs(mu[key]) < SMALL * np.abs(mu[key]).max()
            err = np.abs(got - want)
            assert err[~small].max(initial=0) <= PARAM_ATOL, key
            assert err[small].max(initial=0) <= 1.01 * 3e-4, key


def _local_bytes(spec, shape, dtype, mesh) -> int:
    n = 1
    for d, part in zip(shape, tuple(spec) + (None,) * len(shape)):
        axes = (part,) if isinstance(part, str) else (part or ())
        n *= d // int(np.prod([mesh.shape[a] for a in axes]))
    return n * np.dtype(dtype).itemsize


def _ref_arg_bytes(arch, shape_name, mesh) -> int:
    """Rank 0's argument bytes from the reference's specs (its parameter,
    cache and batch specs under ``mesh``'s shape)."""
    from repro.distributed import param_specs as jps
    from repro.models import build_model as jbuild
    cfg = jsteps.get_config(arch)
    shape = jsteps.get_shape(shape_name)
    assert shape.kind == "decode" and not cfg.vlm.enabled
    b, s = shape.global_batch, shape.seq_len
    m = jbuild(cfg, dtype=jnp.bfloat16)
    params = jax.eval_shape(lambda: m.init(jax.random.PRNGKey(0)))
    specs = jps.param_pspecs(params, mesh, fsdp=False)
    total = sum(_local_bytes(sp, x.shape, x.dtype, mesh) for sp, x in zip(
        jax.tree.leaves(specs, is_leaf=lambda t: isinstance(t, tuple)),
        jax.tree.leaves(params)))
    for x in jax.tree.leaves(jax.eval_shape(
            lambda: m.init_cache(b, s, jnp.bfloat16))):
        st = len(x.shape) >= 2 and x.shape[0] != b and x.shape[1] == b
        total += _local_bytes(jps.cache_pspec(tuple(x.shape), mesh, batch=b,
                                              stacked=st),
                              x.shape, x.dtype, mesh)
    total += _local_bytes(jps.batch_pspec(mesh, b), (b, 1), np.int32, mesh)
    return total + 4                                # the int32 position


def test_run_pair_at_smoke_size_on_a_fake_4x4_world(monkeypatch):
    _smoke(monkeypatch, 256, 8)
    with mesh_lib.fake_world(16):
        mesh = mesh_lib.make_test_mesh((4, 4))
        rec = dryrun.run_pair("granite-3-2b", "decode_32k", "single",
                              save=False, mesh=mesh)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["chips"] == 16
    assert rec["memory"]["argument_size_in_bytes"] == \
        _ref_arg_bytes("granite-3-2b", "decode_32k", _StubMesh(mesh))
    assert rec["attn_impl"] == {
        "requested": "auto", "lowering_backend": "meta",
        "resolved": "chunked", "card_resolved": "sparse",
        "divergent_from_card": True}
    assert rec["cost"]["flops"] > 0 and rec["collectives"]
    assert rec["dominant"] in ("compute_s", "memory_s", "collective_s")
    assert not dist.is_initialized()


def test_run_pair_full_size_decode_on_the_production_mesh():
    rec = dryrun.run_pair("llama3-8b-262k", "decode_32k", "single",
                          save=False)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["chips"] == 256
    assert rec["memory"]["argument_size_in_bytes"] == _ref_arg_bytes(
        "llama3-8b-262k", "decode_32k",
        _StubMesh(type("M", (), {"axis_names": ("data", "model"),
                                 "shape": {"data": 16, "model": 16}})))
    assert rec["model_flops"] == dryrun.model_flops("llama3-8b-262k",
                                                    "decode_32k")
    assert set(rec["roofline"]) == {"compute_s", "memory_s", "collective_s",
                                    "collective_bytes", "flops",
                                    "bytes_accessed"}
    assert not dist.is_initialized()


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
def test_dryrun_accounting_equals_a_plain_run(shape, monkeypatch, tmp_path,
                                              one_torch_thread):
    """What the card's phase 23 holds, at smoke size on the CPU: the
    dry-run's accounting on a fake world of one rank (meta shards) against
    the same step on plain tensors with values on a gloo world of one rank:
    argument bytes exactly, FLOPs exactly those ``FlopCounterMode``
    counts."""
    from torch.utils.flop_counter import FlopCounterMode
    _smoke(monkeypatch, 512, 2)
    arch = "llama3-8b-262k"
    with mesh_lib.fake_world(1):
        rec = dryrun.analyse_step(steps.build_step(
            arch, shape, mesh_lib.make_test_mesh((1, 1))))
    gen = torch.Generator().manual_seed(0)

    def make(key, shape_, dtype):
        if not dtype.is_floating_point:
            return torch.randint(0, 64, shape_, generator=gen, dtype=dtype)
        return (torch.randn(shape_, generator=gen) * 0.1).to(dtype)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        tb = steps.build_step(arch, shape, mesh_lib.make_test_mesh((1, 1)))
        args = steps.plain_args(tb, make)
        with FlopCounterMode(display=False) as fc:
            logits, _ = tb.fn(*args)
    finally:
        dist.destroy_process_group()
    assert sa.tree_bytes(args) == rec["memory"]["argument_size_in_bytes"]
    assert fc.get_total_flops() == rec["cost"]["flops"] > 0
    assert torch.isfinite(logits.float()).all()
    assert rec["memory"]["output_size_in_bytes"] == sa.nbytes(logits)

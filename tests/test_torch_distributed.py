"""The port's sharding rules and partition specs (A.12) against the JAX
package's, exactly, and the decode split rule a head shard takes.

Specs are pure functions of leaf paths, shapes and ``mesh.shape``: both
packages get the same stub meshes (``.shape``/``.axis_names``, as the
reference's own ``test_leaf_pspec_divisibility_fallback`` passes one).
Every registry config's **full-size** parameter tree is compared: the
reference's from ``jax.eval_shape`` and the port's built on the ``meta``
device (nothing is allocated), under the reference's key paths
(:func:`repro_torch.checkpoint.params_to_tree`).
"""
import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

from repro.configs.registry import REGISTRY as J_REGISTRY
from repro.core import pattern_dict as jpd
from repro.distributed import param_specs as jps
from repro.distributed import sharding as jsh
from repro.models.api import build_model as j_build
from repro_torch import checkpoint
from repro_torch import tree as tu
from repro_torch.configs.registry import REGISTRY
from repro_torch.core import pattern_dict as tpd
from repro_torch.distributed import param_specs as tps
from repro_torch.distributed import sharding as tsh
from repro_torch.kernels import decode_attn as da
from repro_torch.launch import mesh as mesh_lib
from repro_torch.kernels.indices import compact_block_mask
from repro_torch.models import build_model

from test_torch_redesign import fake_launch  # noqa: F401  (a fixture)


class StubMesh:
    def __init__(self, **shape):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)


MESHES = [dict(data=16, model=16), dict(data=1, model=2),
          dict(data=2, model=2), dict(pod=2, data=16, model=16)]
MESH_IDS = ["16x16", "1x2", "2x2", "pod2x16x16"]


def _at(tree, keys):
    """The node at ``keys`` (spec and placement leaves are tuples, which
    ``flatten_with_path`` would walk into)."""
    for k in keys:
        tree = tree[int(k) if isinstance(tree, (list, tuple)) else k]
    return tree


def _ref_keys(path):
    return tuple(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)


@pytest.fixture(scope="module")
def trees():
    """Every config's full-size parameter leaves, ``{arch: {key path:
    (reference shape, port shape)}}``, and the reference's cache shapes."""
    out = {}
    for name, jcfg in J_REGISTRY.items():
        jm = j_build(jcfg)
        ref = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0)))
        cache = jax.eval_shape(lambda: jm.init_cache(4, 1024))
        cfg = REGISTRY[name]
        port = checkpoint.params_to_tree(
            build_model(cfg, device="meta").init(torch.Generator()), cfg)
        rk = {_ref_keys(p): tuple(x.shape)
              for p, x in jax.tree_util.tree_flatten_with_path(ref)[0]}
        pk = {tuple(k.split(tu.SEP)): tuple(x.shape)
              for k, x in tu.flatten_with_path(port)}
        out[name] = dict(ref=rk, port=pk, port_tree=port,
                         cache=[tuple(x.shape)
                                for x in jax.tree.leaves(cache)])
    return out


def test_port_trees_have_the_reference_keys_and_shapes(trees):
    for name, t in trees.items():
        assert t["port"] == t["ref"], name


@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
def test_param_pspecs_equal_the_reference(trees, shape, fsdp):
    mesh = StubMesh(**shape)
    n = 0
    for name, t in trees.items():
        specs = tps.param_pspecs(t["port_tree"], mesh, fsdp=fsdp)
        for keys, shp in t["ref"].items():
            want = tuple(jps.leaf_pspec(keys, shp, mesh, fsdp=fsdp))
            assert tuple(tps.leaf_pspec(keys, shp, mesh, fsdp=fsdp)) \
                == want, (name, keys)
            got = _at(specs, keys)
            assert isinstance(got, tps.P) and tuple(got) == want, (name,
                                                                   keys)
            n += 1
    assert n > 200                   # every leaf of the twelve trees


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
def test_batch_and_cache_pspecs_equal_the_reference(trees, shape):
    mesh = StubMesh(**shape)
    for batch in (1, 2, 3, 4, 16, 64, 256):
        assert tuple(tps.batch_pspec(mesh, batch)) \
            == tuple(jps.batch_pspec(mesh, batch)), batch
    for name, t in trees.items():
        for shp in t["cache"]:
            for batch in (4, 1):
                stacked = len(shp) >= 2 and shp[0] != batch \
                    and shp[1] == batch
                assert tuple(tps.cache_pspec(shp, mesh, batch=batch,
                                             stacked=stacked)) \
                    == tuple(jps.cache_pspec(shp, mesh, batch=batch,
                                             stacked=stacked)), (name, shp)
    for shp in ((40, 1, 8, 524288, 128), (40, 128, 16, 32768, 128),
                (1, 512, 64), (59, 1, 4096, 512)):
        for stacked in (True, False):
            assert tuple(tps.cache_pspec(shp, mesh, batch=shp[1],
                                         stacked=stacked)) \
                == tuple(jps.cache_pspec(shp, mesh, batch=shp[1],
                                         stacked=stacked)), shp


def test_shardings_are_the_specs_as_placements(trees):
    mesh = StubMesh(data=2, model=4)
    assert tps.placements(tps.P("data", None, "model"), mesh) \
        == (Shard(0), Shard(2))
    assert tps.placements(tps.P(), mesh) == (Replicate(), Replicate())
    pod = StubMesh(pod=2, data=2, model=2)
    assert tps.placements(tps.P(("pod", "data"), "model"), pod) \
        == (Shard(0), Shard(0), Shard(1))
    t = trees["llama3-8b-262k"]
    got = tps.param_shardings(t["port_tree"], mesh)
    for key, x in tu.flatten_with_path(t["port_tree"]):
        keys = tuple(key.split(tu.SEP))
        spec = tps.leaf_pspec(keys, tuple(x.shape), mesh)
        assert _at(got, keys) == tps.placements(spec, mesh), key
    assert _at(got, ("stack", "attn", "wq")) == (Shard(1), Shard(2))
    cache = build_model(REGISTRY["llama3-8b-262k"], device="meta"
                        ).init_cache(4, 1024)
    places = tps.cache_shardings(cache, mesh, batch=4)
    for key, x in tu.flatten_with_path(cache):
        st = x.shape[0] != 4 and x.shape[1] == 4
        assert _at(places, key.split(tu.SEP)) == tps.placements(
            tps.cache_pspec(tuple(x.shape), mesh, batch=4, stacked=st),
            mesh), key


@pytest.mark.parametrize("overrides", [None, {"mlp": None},
                                       {"heads": ("pod", "model")}])
@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
def test_sharding_rules_spec_equals_the_reference(shape, overrides):
    mesh = StubMesh(**shape)
    t, j = tsh.ShardingRules(mesh, overrides), jsh.ShardingRules(
        mesh, overrides)
    assert t.rules == j.rules                    # missing axes dropped
    names = [None, *tsh.DEFAULT_RULES, "unknown"]
    for a in names:
        for b in names:
            assert tuple(t.spec(a, b)) == tuple(j.spec(a, b)), (a, b)
    assert t.spec("batch") == (("pod", "data") if "pod" in shape
                               else "data",)


@pytest.mark.parametrize("h,hkv", [(32, 8), (8, 8), (12, 2), (6, 3), (1, 1)])
@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
def test_head_shard_count_equals_the_reference(shape, h, hkv):
    mesh = StubMesh(**shape)
    for axis in ("model", "data", "pod", "absent"):
        assert tsh.head_shard_count(mesh, axis, h, hkv) \
            == jsh.head_shard_count(mesh, axis, h, hkv)


def test_routing_rule_follows_the_rules_context():
    assert tsh.active_model_mesh() is None
    one, two = StubMesh(data=2, model=1), StubMesh(data=1, model=2)
    with tsh.use_rules(tsh.ShardingRules(one)):
        assert tsh.active_model_mesh() is None
        with tsh.use_rules(tsh.ShardingRules(two)):
            assert tsh.active_model_mesh() is two
            assert tsh.shardable_model_mesh(32, 8) is two
            assert tsh.shardable_model_mesh(32, 1) is None   # 1 kv head
        assert tsh.current_rules().mesh is one
    assert tsh.current_rules() is None
    x = torch.arange(6.).reshape(2, 3)
    assert tsh.shard(x, "batch", "mlp") is x


def test_sharded_functions_refuse_heads_that_do_not_shard():
    mesh = StubMesh(data=1, model=2)
    q = torch.zeros(1, 3, 64, 64)
    k = torch.zeros(1, 3, 64, 64)
    with pytest.raises(ValueError, match="do not shard"):
        tsh.sharded_batched_block_sparse_attention(
            q, k, k, torch.ones(1, 3, 1, 1, dtype=torch.bool), mesh=mesh,
            block_size=64)
    plan = da.DecodePlan(torch.zeros(1, 1, 2, dtype=torch.int32),
                         torch.zeros(1, 1, dtype=torch.int32),
                         torch.zeros(1, 1, 2, 2, dtype=torch.bool))
    with pytest.raises(ValueError, match="do not shard"):
        tsh.sharded_flash_decode(torch.zeros(1, 2, 64),
                                 torch.zeros(1, 1, 128, 64),
                                 torch.zeros(1, 1, 128, 64), plan,
                                 torch.ones(1, 128, dtype=torch.bool),
                                 mesh=mesh)
    with pytest.raises(ValueError, match="do not shard"):
        tsh.sharded_flash_decode_paged(
            torch.zeros(1, 2, 64), torch.zeros(3, 1, 64, 64),
            torch.zeros(3, 1, 64, 64), torch.ones(1, 2, dtype=torch.int32),
            plan, torch.ones(1, 128, dtype=torch.bool), mesh=mesh)


def test_merge_across_devices_is_the_identity():
    rng = np.random.default_rng(0)
    arrays = (rng.random((2, 3, 4, 4)) < 0.5, rng.random((2, 3, 4)),
              rng.random((2, 3)) < 0.5)
    t = tpd.PivotalState(*(torch.as_tensor(a) for a in arrays))
    j = jpd.PivotalState(*arrays)
    assert tpd.merge_across_devices(t) is t
    assert jpd.merge_across_devices(j) is j


def test_a_shard_splits_decode_rows_as_the_whole_model():
    """Phase 4's decode (B = 2, Hkv = 8, NB = 65 on 132 SMs): a shard of 4
    kv heads splits each row into 65 by its own count, into the
    single-device 33 with the model's; nothing else moves."""
    assert da.decode_splits(2, 8, 65, 132) == 33
    assert da.decode_splits(2, 4, 65, 132) == 65


def test_decode_wrappers_split_a_shard_by_the_model_kv_heads(fake_launch):
    b, h, hkv, nb, ps, d = 2, 16, 4, 65, 32, 128     # one shard of 32/8
    s = nb * ps
    q = torch.zeros(b, h, d)
    cache = torch.zeros(b, hkv, s, d)
    idx, cnt = compact_block_mask(torch.ones(b, hkv, nb, dtype=torch.bool))
    keep = torch.ones(b, hkv, nb, h // hkv, dtype=torch.bool)
    valid = torch.ones(b, s, dtype=torch.bool)
    pool = torch.zeros(b * nb + 1, hkv, ps, d)
    table = torch.arange(1, b * nb + 1, dtype=torch.int32).reshape(b, nb)
    for kv in (None, 8):
        da.flash_decode_sparse_cuda(q, cache, cache, idx, cnt, keep, valid,
                                    num_kv_heads=kv)
        da.flash_decode_sparse_paged_cuda(q, pool, pool, table, idx, cnt,
                                          keep, valid, num_kv_heads=kv)
    plan = [c[-2] for c in fake_launch["repro_decode_attn"].calls]
    paged = [c[-2] for c in fake_launch["repro_decode_attn_paged"].calls]
    assert plan == paged == [65, 33]
    # the scratch holds (B, H, splits, D + 2) partials of the split taken
    splits, part = da._decode_scratch(q, b, h, hkv, nb, 8)
    assert splits == 33 and part.numel() == b * h * 33 * (d + 2)


@pytest.mark.parametrize("start", [0, 4])
def test_decode_wrappers_read_a_head_slice_in_place(fake_launch, start):
    """A shard's kv heads of the whole cache and pool (8 kv heads, 4 a
    shard) reach the kernel as views: K/V pointers at the shard's first
    head and Hc = 8, the heads a batch row (a page) steps over; the
    contiguous launch passes Hc = Hkv.  Other layouts raise."""
    b, h, hkv, nb, ps, d = 2, 16, 4, 65, 32, 128
    s = nb * ps
    q = torch.zeros(b, h, d)
    cache = torch.zeros(b, 2 * hkv, s, d)
    pool = torch.zeros(b * nb + 1, 2 * hkv, ps, d)
    idx, cnt = compact_block_mask(torch.ones(b, hkv, nb, dtype=torch.bool))
    keep = torch.ones(b, hkv, nb, h // hkv, dtype=torch.bool)
    valid = torch.ones(b, s, dtype=torch.bool)
    table = torch.arange(1, b * nb + 1, dtype=torch.int32).reshape(b, nb)
    ks = slice(start, start + hkv)
    ck, pk = cache[:, ks], pool[:, ks]
    assert not ck.is_contiguous() and not pk.is_contiguous()
    da.flash_decode_sparse_cuda(q, ck, ck, idx, cnt, keep, valid,
                                num_kv_heads=8)
    da.flash_decode_sparse_paged_cuda(q, pk, pk, table, idx, cnt, keep,
                                      valid, num_kv_heads=8)
    da.flash_decode_sparse_cuda(q, ck.contiguous(), ck.contiguous(), idx,
                                cnt, keep, valid)
    (plan, whole), (paged,) = (fake_launch[name].calls for name in (
        "repro_decode_attn", "repro_decode_attn_paged"))
    # ints: dtype, B, H, Hkv, Hc, … after the nine (ten) pointers
    assert plan[1].value == ck.data_ptr() == cache.data_ptr() \
        + start * s * d * 4
    assert paged[1].value == pk.data_ptr() == pool.data_ptr() \
        + start * ps * d * 4
    assert plan[12:14] == (hkv, 2 * hkv) and paged[13:15] == (hkv, 2 * hkv)
    assert whole[12:14] == (hkv, hkv)
    for bad in (torch.zeros(2 * hkv, b, s, d).transpose(0, 1)[:, ks],
                torch.zeros(b, 2 * hkv, d, s).transpose(2, 3)[:, ks]):
        with pytest.raises(ValueError, match="head slice"):
            da.flash_decode_sparse_cuda(q, bad, bad, idx, cnt, keep, valid)
    with pytest.raises(ValueError, match="head slice"):
        da.flash_decode_sparse_cuda(q, ck, ck.contiguous(), idx, cnt, keep,
                                    valid)


@pytest.mark.parametrize("rank,world,cards,env,want", [
    (0, 1, 0, {}, None),                         # no card: raises
    (1, 2, 1, {}, ("gloo", 0)),                  # two ranks share a card
    (1, 2, 2, {}, ("nccl", 1)),                  # a card a rank
    (3, 4, 2, {}, ("gloo", 1)),
    # torchrun over nodes of 8 cards: the node's ranks decide, and the
    # card is the local rank's
    (259, 512, 8, {"LOCAL_RANK": "3", "LOCAL_WORLD_SIZE": "8"},
     ("nccl", 3)),
    (21, 32, 8, {"LOCAL_RANK": "5", "LOCAL_WORLD_SIZE": "16"},
     ("gloo", 5)),
])
def test_rank_backend_follows_the_node_s_ranks_and_cards(rank, world, cards,
                                                         env, want):
    if want is None:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh_lib.rank_backend(rank, world, "cuda", cards, env)
        return
    assert mesh_lib.rank_backend(rank, world, "cuda", cards, env) == (
        want[0], torch.device("cuda", want[1]))
    assert mesh_lib.rank_backend(rank, world, "cpu", cards, env) == (
        "gloo", torch.device("cpu"))


def test_process_group_helper_never_picks_the_cpu_for_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh_lib.init_process_group(0, 1, init_method="file:///nowhere")
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        mesh_lib.init_process_group(0, 1, init_method="file:///nowhere",
                                    device="tpu")
    assert not dist.is_initialized()


def test_mesh_factories_and_all_gather_in_a_one_rank_world(tmp_path):
    """The factories over a world of one gloo rank on the CPU (the
    two-rank world is ``test_torch_mesh_serve.py``'s)."""
    mesh_lib.init_process_group(0, 1, init_method=f"file://{tmp_path}/s",
                                device="cpu")
    try:
        mesh = mesh_lib.make_serving_mesh()
        assert mesh.axis_names == ("data", "model")
        assert mesh.shape == {"data": 1, "model": 1}
        assert mesh.index("model") == 0
        assert tsh.ShardingRules(mesh).spec("heads") == ("model",)
        with tsh.use_rules(tsh.ShardingRules(mesh)):
            assert tsh.active_model_mesh() is None     # model axis of 1
        with pytest.raises(ValueError, match="needs 2 devices, have 1"):
            mesh_lib.make_serving_mesh(2)
        with pytest.raises(ValueError, match="needs 256 ranks"):
            mesh_lib.make_production_mesh()
        with pytest.raises(ValueError, match="needs 512 ranks"):
            mesh_lib.make_production_mesh(multi_pod=True)
        assert mesh_lib.make_test_mesh((1, 1)).shape == {"data": 1,
                                                         "model": 1}
        tsh.reset_gather_stats()
        # any dtype, a non-contiguous view too, comes back exactly
        for x in (torch.arange(6.).reshape(2, 3).to(torch.bfloat16),
                  torch.tensor([[True, False]]),
                  torch.arange(10).reshape(2, 5).t()):
            (got,) = tsh.all_gather(x, mesh.group("model"))
            assert got.dtype == x.dtype and torch.equal(got, x)
        assert tsh.GATHER_STATS["calls"] == 3
        assert tsh.GATHER_STATS["bytes"] == 12 + 2 + 80
    finally:
        dist.destroy_process_group()

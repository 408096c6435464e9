"""The port's offline head clustering (``repro_torch.core.clustering``,
ROADMAP.md A.11) and the core's small parity pieces against the JAX
package's, on the CPU.

Inputs come from numpy seeds; the autoencoder's parameters are the
reference's ``init_autoencoder(PRNGKey(seed))`` carried across by
``autoencoder_from_numpy`` (HWIO → OIHW, ``enc_w``'s rows from the NHWC
flatten order to NCHW).  Float32, no TF32.

What is held, and how tightly:
  * ``agglomerative_cluster`` labels and ``jaccard_similarity_matrix``:
    **exactly** (the same numpy code on the same inputs);
  * ``pool_map`` (both branches: a map smaller than the pooled side is
    repeated up first; a side that is no multiple of it is cropped) and
    ``binarize_maps``: within ``MAP_ATOL``;
  * ``encode``/``decode``: within ``AE_ATOL``; the parameters after 5 Adam
    steps (``patience`` above 5): within ``ADAM_ATOL``;
  * ``cluster_heads`` at the reference's bench settings on maps from the
    reference's ``capture_block_attention_maps`` (granite-3-2b's smoke
    config at 4 layers × 8 heads, 512 tokens, block 16): latents within
    ``AE_ATOL``; ``cluster_ids`` equal, where the reference's labels stay
    the same with the threshold moved by the latents' largest possible
    distance error either way (the near-tie rule's margin, asserted);
  * a clustering artifact in the reference's JSON drives both packages'
    ``prefill(method="share", attn_impl="sparse")`` to the same masks,
    ``(indices, counts)`` tables and per-head decisions (exactly) and
    logits within ``LOGIT_ATOL``; the port's artifact loads into the
    reference with equal ids;
  * ``init_pivotal_state`` equal, ``normalize`` within 1e-7.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import clustering as jc
from repro.core import jsd as jjsd
from repro.core import pattern_dict as jpd
from repro.core import profile as jprofile
from repro.core import share_attention as jsa
from repro.core.api import SharePrefill as JSharePrefill
from repro.kernels import indices as jind
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import transformer as jtf
from repro_torch.core import clustering as tc
from repro_torch.core import init_pivotal_state, jsd
from repro_torch.core import share_attention as sa
from repro_torch.core.api import SharePrefill
from repro_torch.kernels import indices as tind
from repro_torch.models import attention, common, transformer

from torch_serving_helpers import make_pair, one_torch_thread  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False

MAP_ATOL = 1e-6
AE_ATOL = 1e-5
ADAM_ATOL = 1e-5
LOGIT_ATOL = 1e-4
SEQ = 512
T = lambda a: torch.from_numpy(np.array(a))


def _ref_init(seed: int = 0):
    return {k: np.asarray(v)
            for k, v in jc.init_autoencoder(jax.random.PRNGKey(seed)).items()}


@pytest.mark.parametrize("seed,n,thr", [(0, 40, 0.8), (1, 64, 1.1),
                                        (2, 30, 0.5), (3, 50, 10.0)])
def test_agglomerative_cluster_labels_are_exact(seed, n, thr):
    x = np.random.default_rng(seed).standard_normal((n, 6)).astype(np.float32)
    np.testing.assert_array_equal(tc.agglomerative_cluster(x, thr),
                                  jc.agglomerative_cluster(x, thr))


def test_agglomerative_cluster_tie_order_is_exact():
    """Points on a grid: many equal distances, merged in ``np.argmin``'s
    order over the alive sub-matrix."""
    g = np.stack(np.meshgrid(np.arange(5), np.arange(4)), -1)
    x = g.reshape(-1, 2).astype(np.float64)
    for thr in (1.01, 1.5, 2.5):
        got = tc.agglomerative_cluster(x.copy(), thr)
        np.testing.assert_array_equal(got, jc.agglomerative_cluster(x, thr))
        assert len(set(got)) > 1


def test_jaccard_similarity_matrix_is_exact():
    m = np.random.default_rng(4).random((12, 8, 8)) < 0.4
    np.testing.assert_array_equal(tc.jaccard_similarity_matrix(m),
                                  jc.jaccard_similarity_matrix(m))


@pytest.mark.parametrize("nb", [4, 20, 32, 48, 100])
def test_pool_and_binarize_match_reference(nb):
    m = np.random.default_rng(nb).random((6, nb, nb)).astype(np.float32)
    ref = np.asarray(jc.pool_map(jnp.asarray(m)))
    got = tc.pool_map(T(m))
    assert tuple(got.shape) == ref.shape == (6, 32, 32)
    np.testing.assert_allclose(got.numpy(), ref, atol=MAP_ATOL, rtol=0)
    np.testing.assert_allclose(tc.binarize_maps(T(ref)).numpy(),
                               np.asarray(jc.binarize_maps(jnp.asarray(ref))),
                               atol=MAP_ATOL, rtol=0)


def test_encode_decode_match_reference():
    ref = _ref_init(3)
    params = tc.autoencoder_from_numpy(ref)
    maps = np.random.default_rng(5).random((10, 32, 32)).astype(np.float32)
    z_ref = np.asarray(jc.encode(ref, jnp.asarray(maps)))
    z = tc.encode(params, T(maps))
    np.testing.assert_allclose(z.numpy(), z_ref, atol=AE_ATOL, rtol=0)
    np.testing.assert_allclose(
        tc.decode(params, T(z_ref)).numpy(),
        np.asarray(jc.decode(ref, jnp.asarray(z_ref))), atol=AE_ATOL, rtol=0)
    # the layout trap: enc_w's rows left in the NHWC order give other
    # latents
    naive = dict(params, enc_w=T(ref["enc_w"]))
    assert not np.allclose(tc.encode(naive, T(maps)).numpy(), z_ref,
                           atol=1e-2)


def test_adam_steps_match_reference():
    """Five full-batch Adam steps from the same start (``patience`` 30, so
    no early stop), every parameter within ``ADAM_ATOL``."""
    ref = _ref_init(1)
    maps = np.random.default_rng(6).random((16, 32, 32)).astype(np.float32)
    trained = jc.train_autoencoder(jnp.asarray(maps), epochs=5, seed=1)
    got = tc.train_autoencoder(T(maps), epochs=5,
                               params=tc.autoencoder_from_numpy(ref))
    want = tc.autoencoder_from_numpy({k: np.asarray(v)
                                      for k, v in trained.items()})
    assert set(got) == set(want)
    for k in want:
        assert not torch.equal(got[k], tc.autoencoder_from_numpy(ref)[k])
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   atol=ADAM_ATOL, rtol=0, err_msg=k)


def test_train_without_params_draws_from_the_seed():
    maps = torch.rand((4, 32, 32), generator=torch.Generator().manual_seed(0))
    a, b = (tc.train_autoencoder(maps, epochs=2, seed=7) for _ in range(2))
    assert all(torch.equal(a[k], b[k]) for k in a)
    c = tc.train_autoencoder(maps, epochs=2, seed=8)
    assert not torch.equal(a["conv1"], c["conv1"])


@pytest.fixture(scope="module")
def clustered():
    """Maps from the reference's profiling capture, clustered by both
    packages at the reference's bench settings."""
    p = make_pair("granite-3-2b", num_layers=4, num_heads=8, num_kv_heads=2)
    toks = np.random.default_rng(0).integers(
        0, p["cfg"].vocab_size, (1, SEQ)).astype(np.int32)
    maps = jprofile.capture_block_attention_maps(
        p["jp"], p["jm"].cfg, jnp.asarray(toks), block_size=16)
    kw = dict(distance_threshold=None, min_cluster_size=2, ae_epochs=200)
    ref = jc.cluster_heads(jnp.asarray(maps), **kw)
    got = tc.cluster_heads(maps, params=tc.autoencoder_from_numpy(
        _ref_init(0)), **kw)
    return dict(p, maps=maps, ref=ref, got=got)


def test_cluster_heads_matches_reference(clustered):
    ref, got = clustered["ref"], clustered["got"]
    np.testing.assert_allclose(got.latents, ref.latents, atol=AE_ATOL,
                               rtol=0)
    # the near-tie rule: the largest change of a latent distance the
    # latents' difference allows, and the reference's labels unchanged
    # with its threshold moved that far either way
    z = ref.latents
    tol = (2 * np.linalg.norm(got.latents - z, axis=-1).max()
           + abs(got.distance_threshold - (thr := float(np.percentile(
               tc.pairwise_distances(z)[~np.eye(len(z), dtype=bool)],
               25.0)))))
    labels = jc.agglomerative_cluster(z, thr)
    for moved in (thr - tol, thr + tol):
        np.testing.assert_array_equal(jc.agglomerative_cluster(z, moved),
                                      labels)
    np.testing.assert_array_equal(got.cluster_ids, ref.cluster_ids)
    assert got.num_clusters == ref.num_clusters > 1
    assert got.cluster_ids.dtype == np.int32
    assert got.epochs == 200 and np.isfinite(got.final_loss)
    # sharing crosses heads: a cluster holds two different head indices
    ids = got.cluster_ids
    assert any(len({h for _, h in zip(*np.nonzero(ids == c))}) > 1
               for c in range(got.num_clusters))


def _artifact(res) -> str:
    """The reference's artifact format (``benchmarks/common.py``)."""
    return json.dumps({"cluster_ids": res.cluster_ids.tolist(),
                       "num_clusters": int(res.num_clusters)})


def test_artifact_loads_both_ways(clustered):
    cfg = clustered["cfg"].share_prefill
    for res in (clustered["ref"], clustered["got"]):
        d = json.loads(_artifact(res))
        mine = SharePrefill.from_clustering(
            cfg, np.asarray(d["cluster_ids"], np.int32), d["num_clusters"])
        theirs = JSharePrefill.from_clustering(
            clustered["jm"].cfg.share_prefill,
            np.asarray(d["cluster_ids"], np.int32), d["num_clusters"])
        np.testing.assert_array_equal(mine.cluster_ids, theirs.cluster_ids)
        np.testing.assert_array_equal(mine.cluster_ids, res.cluster_ids)
        assert mine.num_clusters == theirs.num_clusters == res.num_clusters


def test_artifact_drives_share_prefill_like_the_reference(clustered):
    """Layer by layer, each package's masks, B.2 tables and decisions from
    its own layer input under the reference's artifact (exactly); the
    whole prefill's logits and dictionary."""
    p = clustered
    d = json.loads(_artifact(p["ref"]))
    ids = np.asarray(d["cluster_ids"], np.int32)
    cfg, jcfg = p["cfg"], p["jm"].cfg
    tsp = SharePrefill.from_clustering(cfg.share_prefill, ids,
                                       d["num_clusters"])
    jsp = JSharePrefill.from_clustering(jcfg.share_prefill, ids,
                                        d["num_clusters"])
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, SEQ)).astype(np.int32)
    jr = p["jm"].prefill(p["jp"], jnp.asarray(toks), jsp, method="share",
                         attn_impl="sparse")
    tr = p["tm"].prefill(p["tp"], T(toks).long(), tsp, method="share",
                         attn_impl="sparse")
    np.testing.assert_allclose(tr.last_logits.numpy(),
                               np.asarray(jr.last_logits), atol=LOGIT_ATOL,
                               rtol=0)
    pos = np.broadcast_to(np.arange(SEQ), (2, SEQ))
    jpos, tpos = jnp.asarray(pos, jnp.int32), T(pos)
    jx = p["jp"]["embed"][jnp.asarray(toks)]
    tx = p["tp"]["embed"][T(toks).long()]
    jst, tst = jsp.init_state(2, SEQ), tsp.init_state(2, SEQ)
    jids, tids = jsp.layer_cluster_ids(), tsp.layer_cluster_ids()
    shared = 0
    for li in range(cfg.num_layers):
        jl = jax.tree.map(lambda a: a[li], p["jp"]["stack"])
        tl = p["tp"]["layers"][li]
        h = jcommon.rmsnorm(jl["ln1"], jx, jcfg.rms_norm_eps)
        q, k, _ = jcommon.gqa_qkv(jl["attn"], h)
        q, k = jattn.rope_qk(q, k, jpos, jcfg)
        jmasks, jdec = jax.vmap(
            lambda qb, kb, st: jsa.build_share_masks(
                qb, kb, st, jids[li], jcfg.share_prefill))(q, k, jst)
        h = common.rmsnorm(tl["ln1"], tx, cfg.rms_norm_eps)
        q, k, _ = common.gqa_qkv(tl["attn"], h)
        q, k = attention.rope_qk(q, k, tpos, cfg)
        tmasks, tdec = sa.build_share_masks(q, k, tst, tids[li],
                                            cfg.share_prefill)
        np.testing.assert_array_equal(tmasks.numpy(), np.asarray(jmasks))
        for f in ("use_shared", "use_dense", "use_vs"):
            np.testing.assert_array_equal(getattr(tdec, f).numpy(),
                                          np.asarray(getattr(jdec, f)))
        shared += int(tdec.use_shared.sum())
        for a, b in zip(tind.compact_block_mask(tmasks),
                        jind.compact_block_mask(jmasks)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        jx, _, jst, _ = jtf.layer_prefill(
            jl, jx, jcfg, jpos, jsp, jst, jids[li], method="share",
            moe_ffn=False, attn_impl="sparse")
        tx, _, tst, _ = transformer.layer_prefill(
            tl, tx, cfg, tpos, tsp, tst, tids[li], method="share",
            attn_impl="sparse")
    assert shared > 0            # heads took a pivot from their cluster
    for st, ref in ((tst, jst), (tr.sp_state, jr.sp_state)):
        np.testing.assert_array_equal(st.masks.numpy(), np.asarray(ref.masks))
        np.testing.assert_array_equal(st.valid.numpy(), np.asarray(ref.valid))
        np.testing.assert_allclose(st.reps.numpy(), np.asarray(ref.reps),
                                   atol=1e-6)


def test_init_pivotal_state_and_normalize_match_reference():
    got, ref = init_pivotal_state(5, 7), jpd.init_pivotal_state(5, 7)
    for a, b in zip(got, ref):
        assert a.dtype == (torch.bool if b.dtype == bool else torch.float32)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    batched = sa.init_batched_state(3, 5, 7)
    for a, b in zip(batched, got):
        assert torch.equal(a, b.expand(3, *b.shape))
    x = np.random.default_rng(7).standard_normal((4, 9)).astype(np.float32)
    x[1] = -1.0                                 # an all-negative row
    for axis in (-1, 0):
        np.testing.assert_allclose(
            jsd.normalize(T(x), axis).numpy(),
            np.asarray(jjsd.normalize(jnp.asarray(x), axis)), atol=1e-7,
            rtol=0)

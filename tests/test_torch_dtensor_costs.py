"""What each rank of the step bundles' ``DTensor`` program computes and
holds at three sites the dry-run found replicated (ROADMAP.md C.7–C.9):

  * C.7, the loss: ``cross_entropy`` on logits split batch over data and
    vocab over model keeps the vocabulary split through its backward (a
    gather's backward allocated zeros of the global shape on every rank);
  * C.8, the prefill's stacked cache: placed by ``cache_pspec(...,
    stacked=True)``, each rank allocating its own shard (``new_empty`` on a
    ``DTensor`` replicated the stack);
  * C.9, the chunked attention: each rank computes its own (batch, heads)
    shard (``DTensor``'s einsum replicated every head when K/V came
    replicated over the model axis, as GQA's expansion gives them).

Costs are counted on fake worlds (:func:`repro_torch.launch.mesh.
fake_world`, meta shards, nothing moved) under :class:`repro_torch.launch.
step_analysis.StepCounter`; values on plain tensors against the reference
(the loss, bitwise against ``logsumexp − gather``), and on four gloo ranks
of a ``(2, 2)`` mesh against the plain functions
(``tests/torch_dtensor_helpers.py``).
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

from repro.distributed import param_specs as jps
from repro.models import build_model as jbuild
from repro.training.losses import cross_entropy as j_cross_entropy
from repro_torch.distributed import sharding as tsh
from repro_torch.kernels.chunked import chunked_attention
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import step_analysis as sa
from repro_torch.launch import steps
from repro_torch.training.losses import cross_entropy

from test_torch_launch import _local_bytes, _smoke, _StubMesh
from torch_serving_helpers import one_torch_thread  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False


def _placed(x: torch.Tensor, mesh, *place) -> torch.Tensor:
    return distribute_tensor(x.to("meta"), mesh.device_mesh, list(place),
                             src_data_rank=None)


def _rules(mesh):
    """The step bundles' context: the rules and implicit replication."""
    stack = contextlib.ExitStack()
    stack.enter_context(tsh.use_rules(tsh.ShardingRules(mesh)))
    stack.enter_context(implicit_replication())
    return stack


# --------------------------------------------------------------------------
# C.7: the loss
# --------------------------------------------------------------------------

def _logits(seed: int, b: int = 4, s: int = 6, v: int = 96):
    """Logits with a masked-out vocabulary row (all −inf but one) and ties
    at the row maximum (the gold label on the second of two), labels and
    a mask."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, s, v)) * 3).astype(np.float32)
    labels = rng.integers(0, v, (b, s))
    x[0, 1] = -np.inf
    x[0, 1, labels[0, 1]] = 1.5
    top = x[1, 2].max() + 1
    x[1, 2, [7, 11]] = top
    labels[1, 2] = 11                   # argmax's first index is 7
    x[2, 3, [5, labels[2, 3]]] = x[2, 3].max() + 1
    mask = (rng.random((b, s)) < 0.8).astype(np.float32)
    return x, labels, mask


@pytest.mark.parametrize("masked", [False, True], ids=["no-mask", "mask"])
def test_loss_on_plain_tensors_equals_the_reference(masked):
    x, labels, mask = _logits(0)
    m = mask if masked else None
    logits = torch.from_numpy(x).requires_grad_()
    lab = torch.from_numpy(labels)
    loss, metrics = cross_entropy(logits, lab,
                                  None if m is None else torch.from_numpy(m))
    grad, = torch.autograd.grad(loss, logits)

    def ref_loss(z):
        return j_cross_entropy(z, jnp.asarray(labels),
                               None if m is None else jnp.asarray(m))
    (jl, jm), jg = jax.value_and_grad(ref_loss, has_aux=True)(jnp.asarray(x))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=0,
                               atol=1e-6)
    for key in ("ce_loss", "accuracy", "perplexity"):
        np.testing.assert_allclose(float(metrics[key].detach()),
                                   float(jm[key]),
                                   rtol=1e-6, atol=0, err_msg=key)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jg), rtol=0,
                               atol=1e-6)

    # bitwise the loss it replaces: logsumexp − gather, argmax
    ref = torch.from_numpy(x).requires_grad_()
    nll = (torch.logsumexp(ref, -1)
           - torch.gather(ref, -1, lab[..., None])[..., 0])
    w = torch.ones_like(nll) if m is None else torch.from_numpy(m)
    total = torch.clamp(w.sum(), min=1.0)
    old = (nll * w).sum() / total
    old_grad, = torch.autograd.grad(old, ref)
    assert torch.equal(loss, old)
    assert torch.equal(grad, old_grad)
    assert torch.equal(metrics["accuracy"],
                       ((ref.argmax(-1) == lab) * w).sum() / total)


def test_loss_keeps_the_vocabulary_split_through_its_backward(
        one_torch_thread):
    b, s, v = 8, 16, 512
    local = b * s * v * 4 // 16                 # a rank's float32 logits
    with mesh_lib.fake_world(16):
        mesh = mesh_lib.make_test_mesh((4, 4))
        logits = _placed(torch.empty(b, s, v), mesh, Shard(0),
                         Shard(2)).requires_grad_()
        labels = _placed(torch.empty(b, s, dtype=torch.int32), mesh,
                         Shard(0), Replicate())
        with _rules(mesh), sa.StepCounter((logits, labels)) as c:
            loss, _ = cross_entropy(logits, labels)
            grad, = torch.autograd.grad(loss, logits)
    assert c.peak_bytes <= 4 * local, (c.peak_bytes, local)
    assert tuple(grad.placements) == (Shard(0), Shard(2))
    # what crosses ranks is per-token (B, S) terms, never the vocabulary
    moved = max(n["bytes"] for n in c.collectives.values())
    assert moved <= b * s * 8


# --------------------------------------------------------------------------
# C.8: the prefill's stacked cache
# --------------------------------------------------------------------------

def test_prefill_output_is_the_local_cache_and_logits(monkeypatch,
                                                      one_torch_thread):
    seq, batch = 256, 8
    _smoke(monkeypatch, seq, batch)
    arch = "granite-3-2b"
    with mesh_lib.fake_world(16):
        mesh = mesh_lib.make_test_mesh((4, 4))
        bundle = steps.build_step(arch, "prefill_32k", mesh)
        with sa.StepCounter(bundle.args) as c:
            out = bundle.fn(*bundle.args)
        stub = _StubMesh(mesh)
    cfg = steps.get_config(arch)
    m = jbuild(cfg, dtype=jnp.bfloat16)
    cache = sum(_local_bytes(jps.cache_pspec(tuple(x.shape), stub,
                                             batch=batch, stacked=True),
                             x.shape, x.dtype, stub)
                for x in jax.tree.leaves(jax.eval_shape(
                    lambda: m.init_cache(batch, seq, jnp.bfloat16))))
    logits = _local_bytes(jps.batch_pspec(stub, batch),
                          (batch, cfg.vocab_size), jnp.bfloat16, stub)
    # the layer stats and the pattern dictionary: scalars and per-cluster
    # block maps, each rank's share
    rest = sa.tree_bytes((out.stats, out.sp_state))
    assert sa.tree_bytes(out.cache) == cache
    assert sa.tree_bytes(out.last_logits) == logits
    assert c.output_bytes(out) == cache + logits + rest
    assert rest < logits


def test_an_empty_stack_allocates_the_local_shard_alone(one_torch_thread):
    with mesh_lib.fake_world(16):
        mesh = mesh_lib.make_test_mesh((4, 4))
        entry = _placed(torch.empty(8, 4, 64, 32, dtype=torch.bfloat16),
                        mesh, Shard(0), Replicate())
        with tsh.use_rules(tsh.ShardingRules(mesh)), \
                sa.StepCounter((entry,)) as c:
            stack = tsh.empty_stack(entry, 3)
    # cache_pspec: batch over data, kv heads (4) over model
    assert tuple(stack.placements) == (Shard(1), Shard(2))
    assert tuple(stack.to_local().shape) == (3, 2, 1, 64, 32)
    assert c.peak_bytes == sa.nbytes(stack.to_local()) == 3 * 2 * 64 * 32 * 2
    assert tuple(stack.shape) == (3, 8, 4, 64, 32)
    assert stack.stride() == torch.empty(3, 8, 4, 64, 32).stride()
    plain = torch.empty(8, 4, 64, 32)
    assert tsh.empty_stack(plain, 3).shape == (3, 8, 4, 64, 32)


# --------------------------------------------------------------------------
# C.9: the chunked attention
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kv", ["heads", "replicated"])
@pytest.mark.parametrize("stats", [False, True], ids=["out", "stats"])
def test_chunked_attention_computes_a_sixteenth_a_rank(kv, stats,
                                                       one_torch_thread):
    """q placed (batch, heads); K/V placed the same, or over the batch
    alone as GQA's expansion of too few kv heads leaves them."""
    b, h, n, d, bs = 8, 16, 256, 32, 64
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(b, h, n, d, generator=g) for _ in range(3))
    masks = (torch.rand(b, h, n // bs, n // bs, generator=g) < 0.7
             if stats else None)
    kw = dict(block_size=bs, collect_stats=stats, block_mask=masks)
    with sa.StepCounter((q, k, v)) as whole:
        chunked_attention(q, k, v, **kw)
    with mesh_lib.fake_world(16):
        mesh = mesh_lib.make_test_mesh((4, 4))
        kv_place = (Shard(0), Shard(1) if kv == "heads" else Replicate())
        dq = _placed(q, mesh, Shard(0), Shard(1))
        dk, dv = (_placed(x, mesh, *kv_place) for x in (k, v))
        if stats:
            kw["block_mask"] = _placed(masks, mesh, Shard(0), Replicate())
        with _rules(mesh), sa.StepCounter((dq, dk, dv)) as part:
            out = chunked_attention(dq, dk, dv, **kw)
    assert whole.flops == 16 * part.flops > 0
    assert sum(x["count"] for x in part.collectives.values()) == 0
    for o in (out if stats else (out,)):
        assert tuple(o.placements) == (Shard(0), Shard(1))
    assert tuple((out[0] if stats else out).shape) == (b, h, n, d)


# --------------------------------------------------------------------------
# C.10: the FSDP-split tables' logits product and embedding lookup
# --------------------------------------------------------------------------

def test_fsdp_tables_keep_the_logits_and_embeddings_split(one_torch_thread):
    """llama3-8b-262k's train_4k widths on its production mesh (meta
    shards): the hidden model-partial and batch-split as the FFN leaves it,
    the tables split as the training step's FSDP specs split them."""
    from torch.distributed.tensor import DTensor, Partial
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    cfg = get_config("llama3-8b-262k")
    b, s, d, v = 256, 4096, cfg.d_model, cfg.vocab_size
    with mesh_lib.fake_world(256):
        mesh = mesh_lib.make_production_mesh()
        x = DTensor.from_local(
            torch.empty(b // 16, s, d, dtype=torch.bfloat16, device="meta"),
            mesh.device_mesh, [Shard(0), Partial()], run_check=False)
        tokens = _placed(torch.empty(b, s, dtype=torch.int32), mesh,
                         Shard(0), Replicate())
        bf = lambda *shape: torch.empty(shape, dtype=torch.bfloat16)
        params = {"final_norm": {"scale": _placed(bf(d), mesh, Replicate(),
                                                  Replicate())},
                  "lm_head": _placed(bf(d, v), mesh, Shard(0), Shard(1)),
                  "embed": _placed(bf(v, d), mesh, Shard(1), Shard(0))}
        peaks = {}
        with _rules(mesh):
            for tie in (False, True):
                c = dataclasses.replace(cfg, tie_embeddings=tie)
                with sa.StepCounter((x, tokens, params)) as n:
                    logits = transformer.logits_from_hidden(params, c, x)
                assert tuple(logits.placements) == (Shard(0), Shard(2))
                peaks[tie] = n.peak_bytes
            with sa.StepCounter((x, tokens, params)) as n:
                h = transformer.embed_tokens(params, cfg, tokens)
    local_logits = b * s * v * 2 // 256
    for tie, peak in peaks.items():      # the global logits: 269 GB
        assert peak <= 4 * local_logits, (tie, peak)
    assert tuple(h.placements) == (Shard(0), Replicate())
    # the table gathered whole (1.05 GB) and the lookup's batch share
    assert n.peak_bytes <= v * d * 2 + b * s * d * 2 // 16


# --------------------------------------------------------------------------
# Values of the sites on four ranks
# --------------------------------------------------------------------------

def test_the_three_sites_on_four_ranks_equal_the_plain_functions(tmp_path):
    from torch_dtensor_helpers import BLOCK, costs_rank
    x, labels, mask = _logits(1, b=4, s=6, v=96)
    g = torch.Generator().manual_seed(2)
    b, h, hkv, n, d = 4, 4, 2, 64, 16
    q = torch.randn(b, h, n, d, generator=g)
    k, v = (torch.randn(b, hkv, n, d, generator=g)
            .repeat_interleave(h // hkv, 1) for _ in range(2))
    block_mask = torch.rand(b, h, n // BLOCK, n // BLOCK, generator=g) < 0.6
    entries = [torch.randn(b, hkv, n, d, generator=g) for _ in range(3)]
    inputs = dict(logits=torch.from_numpy(x), labels=torch.from_numpy(labels),
                  mask=torch.from_numpy(mask), q=q, k=k, v=v,
                  block_mask=block_mask, entries=entries)
    torch.save(inputs, tmp_path / "inputs.pt")
    mesh_lib.run_ranks(costs_rank, 4, (str(tmp_path / "inputs.pt"),
                                       str(tmp_path / "rank0.pt")),
                       init_file=str(tmp_path / "store"), device="cpu",
                       timeout_s=120.0)
    got = torch.load(tmp_path / "rank0.pt")

    logits = torch.from_numpy(x).requires_grad_()
    loss, metrics = cross_entropy(logits, inputs["labels"], inputs["mask"])
    grad, = torch.autograd.grad(loss, logits)
    # the vocab sums split across two ranks: summation order only
    np.testing.assert_allclose(float(got["loss"]), float(loss.detach()),
                               rtol=1e-6)
    assert float(got["accuracy"]) == float(metrics["accuracy"])
    np.testing.assert_allclose(got["grad"].numpy(), grad.numpy(), rtol=0,
                               atol=1e-7)
    assert got["grad_placements"] == (Shard(0), Shard(2))

    out = chunked_attention(q, k, v, block_size=BLOCK)
    out_m, stats = chunked_attention(q, k, v, block_size=BLOCK,
                                     collect_stats=True,
                                     block_mask=block_mask)
    for key, want in (("out", out), ("out_masked", out_m),
                      ("stats", stats)):
        np.testing.assert_allclose(got[key].numpy(), want.numpy(), rtol=0,
                                   atol=1e-6, err_msg=key)
    assert got["out_placements"] == (Shard(0), Shard(1))

    assert torch.equal(got["stack"], torch.stack(entries))
    # cache_pspec: batch over data, kv heads (2) over model
    assert got["stack_placements"] == (Shard(1), Shard(2))
    assert got["stack_local_shape"] == (3, b // 2, hkv // 2, n, d)

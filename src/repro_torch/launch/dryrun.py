"""Multi-node dry-run: run every (architecture × input shape) step on the
production meshes without data and record its memory, cost and collective
accounting (port of ``repro/launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch llama3-8b-262k --shape decode_32k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

A pair runs in this one process on the CPU, by design: :func:`run_pair`
enters a world of 256 (``single``) or 512 (``multi``) fake ranks
(:func:`repro_torch.launch.mesh.fake_world`), lays out the production mesh,
builds the step bundle (:func:`repro_torch.launch.steps.build_step`:
``DTensor`` arguments over ``meta`` shards) and runs its ``fn`` under
:class:`repro_torch.launch.step_analysis.StepCounter`, as rank 0.  Nothing
is allocated and no card is touched, as the reference's CPU lowering
allocates nothing; it is not a fallback of a card run.

Records land in ``experiments/dryrun_torch/<arch>__<shape>__<mesh>.json``
with the reference's fields.  ``memory`` holds rank 0's local argument
bytes, its outputs' local bytes (outputs written in place into an
argument, the decode cache, counted there) and ``temp_size_in_bytes``, the
peak of the live bytes the step creates less the outputs'; the
reference's ``generated_code_size_in_bytes`` has no counterpart (nothing
is compiled) and is left out.  ``cost`` and the roofline terms are per
rank (rank 0), from the card's data-sheet peaks
(:data:`repro_torch.launch.mesh.PEAK_FLOPS_BF16`, ``HBM_BW``,
``LINK_BW``): predictions, not card measurements.
"""
import argparse
import contextlib
import json
import os
import time
import traceback

from repro_torch.configs import SKIP_PAIRS, dryrun_pairs, get_config, get_shape
from repro_torch.launch.mesh import (
    HBM_BW,
    LINK_BW,
    PEAK_FLOPS_BF16,
    fake_world,
    make_production_mesh,
)
from repro_torch.launch.step_analysis import (
    StepCounter,
    collective_bytes,
    dominant_term,
    roofline_terms,
    tree_bytes,
)

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")


def attn_impl_parity(requested: str = "auto") -> dict:
    """How ``requested`` resolves in the dry-run against the card.

    The dry-run's tensors carry no values, and the sparse path's tables are
    sized by values, so ``auto`` runs the dense chunked path here
    (:func:`repro_torch.launch.steps.step_attn_impl`) — a *different
    attention program* than the block-skipping kernels (B.1, B.2) the card
    runs.  The record flags that divergence so nobody reads a chunked-path
    roofline as the sparse kernels'.
    """
    from repro_torch.launch.steps import step_attn_impl
    from repro_torch.models.attention import resolved_attn_impl
    here = step_attn_impl(requested, values=False)
    card = resolved_attn_impl(requested)
    return {
        "requested": requested,
        "lowering_backend": "meta",
        "resolved": resolved_attn_impl(here),
        "card_resolved": card,
        "divergent_from_card": resolved_attn_impl(here) != card,
    }


def model_flops(arch: str, shape_name: str) -> float:
    """MODEL_FLOPS = 6·N·D (dense) / 6·N_active·D (MoE); decode D = 1 token."""
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    n_params = cfg.param_count()        # active params (MoE: top-k only)
    if shape.kind == "train":
        tokens = shape.seq_len * shape.global_batch
        return 6.0 * n_params * tokens
    if shape.kind == "prefill":
        tokens = shape.seq_len * shape.global_batch
        return 2.0 * n_params * tokens
    return 2.0 * n_params * shape.global_batch      # decode: 1 token/row


def analyse_step(bundle) -> dict:
    """Run ``bundle.fn`` on its arguments under a :class:`StepCounter` and
    return rank 0's record fields: ``memory``, ``cost``, ``collectives``
    and the time the run took (``run_s``)."""
    t0 = time.time()
    with StepCounter(bundle.args) as counter:
        out = bundle.fn(*bundle.args)
    run_s = time.time() - t0
    return {
        "run_s": run_s,
        "memory": {
            "argument_size_in_bytes": float(tree_bytes(bundle.args)),
            "output_size_in_bytes": float(counter.output_bytes(out)),
            "temp_size_in_bytes": float(counter.temp_bytes(out)),
        },
        "cost": {"flops": float(counter.flops),
                 "bytes accessed": float(counter.bytes_accessed),
                 "ops": float(counter.ops)},
        "collectives": collective_bytes(counter),
    }


def run_pair(arch: str, shape_name: str, mesh_kind: str, *,
             method: str = "share", fsdp=None, save: bool = True,
             mesh=None) -> dict:
    """One pair's record.  ``mesh`` replaces the production mesh (a test's
    smaller fake world, entered by the caller)."""
    from repro_torch.launch.steps import build_step
    multi = mesh_kind == "multi"
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "method": method, "attn_impl": attn_impl_parity("auto")}
    t0 = time.time()
    try:
        with (fake_world(512 if multi else 256) if mesh is None
              else contextlib.nullcontext()):
            if mesh is None:
                mesh = make_production_mesh(multi_pod=multi)
            chips = mesh.device_mesh.size()
            rec["chips"] = chips
            bundle = build_step(arch, shape_name, mesh, method=method,
                                fsdp=fsdp)
            rec["build_s"] = time.time() - t0
            rec.update(analyse_step(bundle))
        flops = rec["cost"]["flops"]
        terms = roofline_terms(
            flops=flops, bytes_accessed=rec["cost"]["bytes accessed"],
            coll=rec["collectives"], chips=chips,
            peak_flops=PEAK_FLOPS_BF16, hbm_bw=HBM_BW, link_bw=LINK_BW)
        mf = model_flops(arch, shape_name)
        rec.update({
            "roofline": terms,
            "dominant": dominant_term(terms),
            "model_flops": mf,
            "model_flops_per_chip": mf / chips,
            "useful_flop_ratio": (mf / chips) / flops if flops else 0.0,
            "status": "ok",
        })
    except Exception as e:          # a pair's failure is its record
        rec["status"] = "fail"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()
    rec["total_s"] = time.time() - t0

    if save:
        os.makedirs(OUT_DIR, exist_ok=True)
        path = os.path.join(OUT_DIR,
                            f"{arch}__{shape_name}__{mesh_kind}.json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--method", default="share")
    ap.add_argument("--all", action="store_true",
                    help="run every non-skipped (arch, shape) pair")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args()

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        pairs = list(dryrun_pairs())
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        if (args.arch, args.shape) in SKIP_PAIRS:
            print(f"SKIP {args.arch} {args.shape}: "
                  f"{SKIP_PAIRS[(args.arch, args.shape)]}")
            return
        pairs = [(args.arch, args.shape)]

    n_ok = n_fail = 0
    for arch, shape in pairs:
        for mesh_kind in meshes:
            path = os.path.join(OUT_DIR, f"{arch}__{shape}__{mesh_kind}.json")
            if args.skip_existing and os.path.exists(path):
                with open(path) as f:
                    if json.load(f).get("status") == "ok":
                        print(f"SKIP(existing) {arch} {shape} {mesh_kind}")
                        continue
            rec = run_pair(arch, shape, mesh_kind, method=args.method)
            ok = rec["status"] == "ok"
            n_ok += ok
            n_fail += (not ok)
            if ok:
                r = rec["roofline"]
                ai = rec["attn_impl"]
                div = (f" ATTN-DIVERGED({ai['resolved']}!="
                       f"{ai['card_resolved']})"
                       if ai["divergent_from_card"] else "")
                print(f"OK   {arch:22s} {shape:12s} {mesh_kind:6s} "
                      f"run={rec['run_s']:6.1f}s "
                      f"comp={r['compute_s']:.3e}s mem={r['memory_s']:.3e}s "
                      f"coll={r['collective_s']:.3e}s dom={rec['dominant']}"
                      f"{div}")
            else:
                print(f"FAIL {arch:22s} {shape:12s} {mesh_kind:6s} "
                      f"{rec['error'][:120]}")
    print(f"\n{n_ok} ok, {n_fail} failed")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()

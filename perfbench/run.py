"""Run one cell of the benchmark and print its result line:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The run restarts itself once with
``PYTHONHASHSEED=0`` and every build and kernel cache inside the
checkout's ``build/`` (fixed paths), then measures the port
(``src/repro_torch``) as ``perfbench/harness.py`` says.  It exits with 2
and prints no result where it finds no card, fewer cards than the cell
asks for, no port beside it, or JAX or the JAX package loaded.
"""
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TRITON_CACHE_DIR": "triton", "TORCHINDUCTOR_CACHE_DIR": "inductor",
          "CUDA_CACHE_PATH": "cuda_cache"}


def _restart() -> None:
    env = dict(os.environ)
    env["PYTHONHASHSEED"] = "0"
    env["PERFBENCH_T0"] = repr(time.time())
    env["USE_FLAX"] = "0"
    for key, sub in CACHES.items():
        env[key] = os.path.join(ROOT, "build", sub)
    os.execve(sys.executable, [sys.executable] + sys.argv, env)


def prepare() -> None:
    """Restart once under the run's environment; put the checkout's root
    and ``src`` on the path."""
    if os.environ.get("PYTHONHASHSEED") != "0" or \
            "PERFBENCH_T0" not in os.environ:
        _restart()
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]


def main() -> int:
    prepare()
    t0 = float(os.environ["PERFBENCH_T0"])
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"perfbench: the port is not beside the benchmark: {e}",
              file=sys.stderr)
        return 2
    from perfbench import harness
    return harness.main(sys.argv[1:], t0)


if __name__ == "__main__":
    sys.exit(main())

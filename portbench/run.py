"""Run one benchmark cell of the port (``aosx_torch``) once:

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints the compared numbers, each beside its
limit, as the last lines of standard error, and one JSON object as the last
line of standard output. Needs a CUDA device; exits non-zero without one."""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
# every build and kernel cache at a fixed path inside the checkout; the port
# builds its CUDA libraries into aosx_torch/_build/ itself
CACHE = ROOT / ".portbench_cache"
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(CACHE / "inductor")
os.environ["USE_FLAX"] = "0"
# load from one process with one CPU thread: the program's path is paced by
# the host's dispatch, and idle pool threads that spin after a small CPU op
# take cores from it on a shared host
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
sys.path.insert(0, str(ROOT))

from portbench.harness.runner import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))

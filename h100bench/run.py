"""Entry point of the benchmark: ``python3 h100bench/run.py --workload
<cell> --seed <n> --seconds <s> --trace <0|1>`` from the checkout's root
(see ``h100bench/harness.py``)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from h100bench import harness  # noqa: E402

if __name__ == "__main__":
    harness.main()

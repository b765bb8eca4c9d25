import os
import sys
import traceback

from portbench.harness import main

if __name__ == "__main__":
    try:
        code = main()
    except Exception:  # noqa: BLE001 - a failed run reports and exits 1
        traceback.print_exc()
        code = 1
    sys.stdout.flush()
    sys.stderr.flush()
    # the scheduler's pool threads are not daemons: ending here keeps the
    # result's check lines the last ones on stderr and a stuck thread
    # from holding the process past its result
    os._exit(code)

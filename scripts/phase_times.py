"""Run the chip_smoke.py of the current directory with each of its phases
timed, for a checkout whose chip_smoke.py does not print its phase seconds
itself (one before they were added):

    cd <root of another checkout> && python3 <this repo>/scripts/phase_times.py

Every module-level function of that chip_smoke.py whose name starts with
``phase_`` is wrapped before its ``main()`` runs; its output is the
script's own, and one more line, ``phase seconds: {...}``, in the form
chip_smoke.py's own ``main()`` prints, comes after it (the build's seconds
are in the time to the first phase). Needs the card, as chip_smoke.py does.
"""

import functools
import json
import os
import sys
import time


def main() -> None:
    sys.path.insert(0, os.getcwd())
    import chip_smoke

    seconds = {}

    def timed(phase):
        @functools.wraps(phase)
        def run(*args):
            t = time.perf_counter()
            out = phase(*args)
            seconds[phase.__name__] = round(time.perf_counter() - t, 1)
            return out
        return run

    for name in [n for n in vars(chip_smoke) if n.startswith("phase_")]:
        setattr(chip_smoke, name, timed(getattr(chip_smoke, name)))
    t0 = time.perf_counter()
    try:
        chip_smoke.main()
    finally:
        seconds["total"] = round(time.perf_counter() - t0, 1)
        print("phase seconds: " + json.dumps(seconds))


if __name__ == "__main__":
    main()

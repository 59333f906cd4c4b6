"""Command-line entry points: ``python -m recboard_tpu_torch <command>``.

Commands
--------
recommend   Batch inference: top-k recommendations from a finished run
            (recboard_tpu_torch.serve).

recboard_tpu's other commands (make, run, benchmark, bench) are not
ported yet.
"""

from __future__ import annotations

import sys


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print(__doc__)
        return
    cmd, rest = argv[0], argv[1:]
    if cmd == "recommend":
        from . import serve

        serve.main(rest)
    elif cmd in ("make", "run", "benchmark", "bench"):
        raise SystemExit(f"command {cmd!r} is not ported to recboard_tpu_torch yet")
    else:
        raise SystemExit(f"unknown command {cmd!r}; one of: recommend")


if __name__ == "__main__":
    main()

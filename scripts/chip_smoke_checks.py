"""Hold two runs of ``chip_smoke.py`` to each other check for check.

A check is a line of the script's standard output that states one: it ends
in ``ok`` or ``FAIL``, or asks ``? True`` / ``? False``. Each check line of
the first log, its tag kept and its numbers, paths and lists masked, must
be in the second as often. Prints the checks by tag (``[kernel]``, ``[cnn]``,
...) in both logs and the masked lines that one log has and the other
lacks; exits 1 when the second lacks a check of the first or either holds
a failed one.

    python scripts/chip_smoke_checks.py PARENT_LOG CHANGE_LOG
"""

from __future__ import annotations

import re
import sys
from collections import Counter
from pathlib import Path

NUMBER = re.compile(r"[-+]?(?:\d[\d,]*\.?\d*|\.\d+)(?:e[-+]?\d+)?")
PATH = re.compile(r"/[\w.+-]+(?:/[\w.+-]*)+")
LIST = re.compile(r"\[[^\[\]]*\]")


def checks(path: Path) -> Counter:
    """The masked check lines of a log, counted."""
    out = Counter()
    for line in path.read_text(errors="replace").splitlines():
        line = line.rstrip()
        if not (line.endswith((" ok", ": ok", "FAIL", "? True", "? False"))
                and line.startswith("[")):
            continue
        tag, rest = line.split("]", 1)
        rest = NUMBER.sub("#", PATH.sub("<path>", rest))
        while LIST.search(rest):        # nested lists of numbers and names
            rest = LIST.sub("<list>", rest)
        out[tag + "]" + rest] += 1
    return out


def main(argv) -> int:
    if len(argv) != 2:
        raise SystemExit(__doc__)
    a, b = (checks(Path(p)) for p in argv)
    tags = sorted({k.split("]")[0] + "]" for k in a + b})
    for tag in tags:
        na = sum(v for k, v in a.items() if k.startswith(tag))
        nb = sum(v for k, v in b.items() if k.startswith(tag))
        print(f"{tag:12s} {na:5d} {nb:5d}")
    print(f"{'all':12s} {sum(a.values()):5d} {sum(b.values()):5d}")
    lost, new = a - b, b - a
    for name, lines in (("only in the first", lost),
                        ("only in the second", new)):
        for line, n in sorted(lines.items()):
            print(f"{name} (x{n}): {line}")
    failed = [k for k in a + b if k.endswith(("FAIL", "? False"))]
    for line in failed:
        print(f"failed: {line}")
    return 1 if lost or failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

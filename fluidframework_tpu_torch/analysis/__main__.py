"""``python -m fluidframework_tpu_torch.analysis``: run ``synccheck``
over the port's dispatch loops; prints each finding and exits 1 if there
is any, else prints a one-line summary and exits 0."""
from __future__ import annotations

import sys

from .synccheck import DISPATCH_LOOPS, check_package


def main() -> int:
    findings = check_package()
    for f in findings:
        print(f.format())
    if findings:
        print(f"synccheck: {len(findings)} finding(s)")
        return 1
    print(f"synccheck: clean ({len(DISPATCH_LOOPS)} modules)")
    return 0


if __name__ == "__main__":
    sys.exit(main())

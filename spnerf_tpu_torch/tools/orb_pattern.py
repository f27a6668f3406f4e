"""Re-read OpenCV's rBRIEF table (``orb.cpp``'s ``bit_pattern_31_``) from
a compiled cv2 module and check the copy in ``native/cv_orb.cpp``.

The table is 1,024 int32 (256 tests of two (x, y) points, each in
[-13, 12]); a cv2 build holds it once, as data. The tool finds the only
occurrence of its first eight values in the library and reads 1,024
int32 from there; it does not import cv2 (it only locates the package).

    python -m spnerf_tpu_torch.tools.orb_pattern [--library PATH]
        [--print]

exits non-zero when the prefix is missing or occurs twice, when the
values leave [-13, 12], or when they differ from the port's copy;
``--print`` writes the table as C initialiser lines (four ints a line),
the form ``native/cv_orb.cpp`` holds.
"""

from __future__ import annotations

import argparse
import importlib.util
import sys
from pathlib import Path

import numpy as np

PREFIX = (8, -3, 9, 5, 4, 2, 7, -12)
COUNT = 1024


def cv2_library() -> Path:
    """The compiled cv2 module of this interpreter's cv2 package."""
    spec = importlib.util.find_spec("cv2")
    if spec is None or not spec.submodule_search_locations:
        raise SystemExit("no cv2 package to read the table from")
    for location in spec.submodule_search_locations:
        found = sorted(Path(location).glob("cv2*.so"))
        if found:
            return found[0]
    raise SystemExit("the cv2 package holds no compiled module")


def read_table(library: Path) -> np.ndarray:
    """The (1024,) int32 at the only occurrence of ``PREFIX``."""
    data = Path(library).read_bytes()
    prefix = np.asarray(PREFIX, "<i4").tobytes()
    at = data.find(prefix)
    if at < 0:
        raise SystemExit(f"{library}: the pattern's prefix is missing")
    if data.find(prefix, at + 1) >= 0:
        raise SystemExit(f"{library}: the pattern's prefix occurs twice")
    table = np.frombuffer(data, "<i4", COUNT, at).astype(np.int32)
    if table.min() < -13 or table.max() > 12:
        raise SystemExit(f"{library}: values at {at} leave [-13, 12]")
    return table


def c_lines(table: np.ndarray) -> str:
    return "\n".join("    " + ", ".join(f"{v:3d}" for v in row) + ","
                     for row in table.reshape(-1, 4))


def main(argv=None) -> int:
    from spnerf_tpu_torch.eval import orb

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--library", type=Path, default=None,
                    help="the compiled cv2 module (default: cv2's own)")
    ap.add_argument("--print", action="store_true", dest="show")
    args = ap.parse_args(argv)
    table = read_table(args.library or cv2_library())
    if args.show:
        print(c_lines(table))
    same = np.array_equal(table, orb.pattern())
    print(f"native/cv_orb.cpp's table {'equals' if same else 'DIFFERS FROM'}"
          f" the library's", file=sys.stderr)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())

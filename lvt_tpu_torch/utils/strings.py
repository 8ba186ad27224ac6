"""String helpers (reference: vidgen/utils/strings.py). Natural sort is
load-bearing: frame filenames like ``2.png < 10.png`` must order numerically."""

import argparse
import re

_NUM_RE = re.compile(r"(\d+)")


def natural_keys(text: str):
    return [int(c) if c.isdigit() else c for c in _NUM_RE.split(text)]


def natural_sorted(items):
    return sorted(items, key=natural_keys)


def natural_sort(items):
    items.sort(key=natural_keys)


def str2bool(v: str) -> bool:
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")

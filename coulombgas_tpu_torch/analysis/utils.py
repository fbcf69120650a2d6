"""Run-directory name parsing for post-analysis.

The port's copy of ``coulombgas_tpu/analysis/utils.py``.  The run identity
is encoded entirely in the directory name, which ``main_torch.py`` forms as
``main.py`` does (reference main.py:194-206); this parses it back
(reference analysis/utils.py:3-16).
"""

from __future__ import annotations

import re

__all__ = ["parse_filename", "natural_sort"]


def parse_filename(f: str):
    """Extract (n, dim, rs, Theta, depth, spsize, tpsize, batch) from a path."""
    n = int(re.search(r"n_([0-9]+)_", f).group(1))
    dim = int(re.search(r"dim_([0-9]+)_", f).group(1))
    rs = float(re.search(r"rs_([0-9]*\.?[0-9]*)_", f).group(1))
    T = float(re.search(r"Theta_([0-9]*\.?[0-9]*)_", f).group(1))
    d = int(re.search(r"depth_([0-9]+)_", f).group(1))
    h1 = int(re.search(r"spsize_([0-9]+)_", f).group(1))
    h2 = int(re.search(r"tpsize_([0-9]+)_", f).group(1))
    b_match = re.search(r"batch_([0-9]+)", f)
    b = int(b_match.group(1)) if b_match else None
    return n, dim, rs, T, d, h1, h2, b


def natural_sort(items):
    """Sort strings with embedded integers in human order."""
    convert = lambda text: int(text) if text.isdigit() else text.lower()
    return sorted(items, key=lambda key: [convert(c) for c in re.split(r"([0-9]+)", key)])

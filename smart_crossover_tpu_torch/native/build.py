"""Build the native library:  python -m smart_crossover_tpu_torch.native.build

Port of ``smart_crossover_tpu/native/build.py`` over the port's loader:
the library goes into ``build/smart_crossover_tpu_torch/`` (hashed name,
see ``native/__init__.py``), never into the package directory.
"""
from __future__ import annotations

import sys
from pathlib import Path

from smart_crossover_tpu_torch import native


def build(verbose: bool = True) -> Path:
    """Compile the core unless it is built already; return its path.
    Raises on a failed build."""
    if verbose:
        print(" ".join(["g++", *native.CXX_FLAGS, str(native.SOURCE)]))
    return native.build_library()


if __name__ == "__main__":
    path = build()
    print(f"built {path}")
    sys.exit(0)

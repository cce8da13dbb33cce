"""utils of the PyTorch port (see smart_crossover_tpu/utils)."""
from pathlib import Path

from smart_crossover_tpu_torch.utils.timer import Timer

__all__ = ["Timer"]


def get_project_root() -> Path:
    """Walk up from cwd to the repository root (the first directory holding
    pyproject.toml or .git), as the JAX package's helper does."""
    cur = Path.cwd()
    for p in [cur, *cur.parents]:
        if (p / "pyproject.toml").exists() or (p / ".git").exists():
            return p
    raise FileNotFoundError("project root not found above " + str(cur))


def get_data_dir_path() -> Path:
    return get_project_root() / "data"

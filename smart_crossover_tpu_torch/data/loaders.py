"""Universal instance loader.

The reference's scripts load pickled ``.ot``/``.mcf`` instances, DIMACS
``.min`` files and ``.mps`` LPs (run_network_crossover.py:19-48).  This
resolves by extension to the right reader and returns the in-framework type.

Port of ``smart_crossover_tpu/data/loaders.py``: the same readers, and one
change.  A pickle written by the JAX package names its classes
``smart_crossover_tpu.models.*``, and unpickling it would import that
package and jax; the port's unpickler refuses any ``smart_crossover_tpu.``
module and points to the dict payload, which both packages read, and to
``interop.instance_from_reference``.
"""
from __future__ import annotations

import pickle
from pathlib import Path

from smart_crossover_tpu_torch.models import GeneralLP, MinCostFlow, OptTransport


class _PortUnpickler(pickle.Unpickler):
    """Refuses the JAX package's classes (their import would load jax)."""

    def find_class(self, module, name):
        if module == "smart_crossover_tpu" or module.startswith(
                "smart_crossover_tpu."):
            raise pickle.UnpicklingError(
                f"{module}.{name} is a class of the JAX package, which the "
                "port does not import; save the instance as a dict payload "
                "({'s', 'd', 'M'} for OT, {'tails', 'heads', 'c', 'u', 'b'} "
                "for MCF), or turn the JAX object into the port's with "
                "smart_crossover_tpu_torch.interop.instance_from_reference")
        return super().find_class(module, name)


def load_instance(path: str | Path):
    """Load an OT / MCF / LP instance by file extension.

    ``.ot`` / ``.mcf`` / ``.pkl``: pickled OptTransport or MinCostFlow (as
    written by ``save_instance``); ``.min``: DIMACS min-cost flow;
    ``.mps``/``.mps.gz`` and ``.lp``/``.lp.gz``: general LP.
    """
    path = Path(path)
    suffix = path.suffix.lower()
    if suffix in (".ot", ".mcf", ".pkl"):
        with open(path, "rb") as fh:
            obj = _PortUnpickler(fh).load()
        if isinstance(obj, (OptTransport, MinCostFlow, GeneralLP)):
            return obj
        # tolerate plain dict payloads
        if isinstance(obj, dict):
            if {"s", "d", "M"} <= obj.keys():
                return OptTransport(s=obj["s"], d=obj["d"], M=obj["M"],
                                    name=obj.get("name", path.stem))
            if {"tails", "heads", "c", "u", "b"} <= obj.keys():
                return MinCostFlow(**obj)
        raise ValueError(f"{path}: unrecognised pickle payload {type(obj)}")
    if suffix == ".min":
        from smart_crossover_tpu_torch.data.dimacs import read_dimacs_min

        return read_dimacs_min(path)
    if suffix == ".mps" or path.name.endswith(".mps.gz"):
        from smart_crossover_tpu_torch.data.mps import read_mps

        return read_mps(path)
    if suffix == ".lp" or path.name.endswith(".lp.gz"):
        from smart_crossover_tpu_torch.data.lp_format import read_lp

        return read_lp(path)
    raise ValueError(f"{path}: unknown instance extension {suffix!r}")


def save_instance(obj, path: str | Path) -> None:
    """Pickle an instance (.ot/.mcf convention of the reference scripts)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as fh:
        pickle.dump(obj, fh)

"""Float64 certificates of a batch of transportation bases on the card.

One launch of ``csrc/certify.cu`` certifies the whole batch, a thread block
an instance: it compacts the basis mask, walks the spanning tree from the
last demand node, solves the duals and the flows by elimination and takes
the verdict's numbers (feasibility, the smallest flow, the smallest reduced
cost over every cell, the objective), all in float64.  Its plain version,
the CPU path and the oracle it is held to is the SciPy certifier
``network_methods/certify.py::certify_ot_basis``.  Neither shares code with
the device route whose bases it certifies.

Host arrays reach the card through one pinned staging buffer per device,
kept between calls and grown when a batch is larger, in chunks, so that the
copy into the buffer overlaps the transfer of the chunk before.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from smart_crossover_tpu_torch import _build
from smart_crossover_tpu_torch.utils import trace

# the kernel's status of an instance
TREE, COUNT, CYCLE = 0, 1, 2

_CHUNK = 8 << 20                # bytes a staging copy moves at a time
_STAGING: dict = {}             # device -> pinned uint8 buffer
_LOCK = threading.Lock()        # one batch at a time uses the buffers
_TORCH = {np.dtype(np.uint8): torch.uint8, np.dtype(np.float32): torch.float32,
          np.dtype(np.float64): torch.float64}


def _staging(device: torch.device, nbytes: int) -> torch.Tensor:
    buf = _STAGING.get(device)
    if buf is None or buf.numel() < nbytes:
        buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        _STAGING[device] = buf
    return buf


def _upload(arrays: list, device: torch.device) -> list:
    """Contiguous numpy arrays as tensors on ``device``, copied through the
    pinned staging buffer: each chunk's copy into the buffer is followed by
    its asynchronous transfer, which runs while the next chunk is copied."""
    sizes = [a.nbytes for a in arrays]
    offs = np.cumsum([0] + [-(-n // 256) * 256 for n in sizes]).tolist()
    buf = _staging(device, offs[-1])
    dst = torch.empty(offs[-1], dtype=torch.uint8, device=device)
    out = []
    for a, o, n in zip(arrays, offs, sizes):
        src = torch.from_numpy(a.reshape(-1).view(np.uint8))
        for c in range(0, n, _CHUNK):
            e = min(n, c + _CHUNK)
            buf[o + c:o + e].copy_(src[c:e])
            dst[o + c:o + e].copy_(buf[o + c:o + e], non_blocking=True)
        out.append(dst[o:o + n].view(_TORCH[a.dtype]).view(a.shape))
    return out


def _cost_dtype(dtype) -> bool:
    return dtype in (np.float32, np.float64, torch.float32, torch.float64)


def certify_batch_cuda(Bm, s, d, M, device) -> tuple:
    """Launch the certificate kernel on a batch: ``Bm`` (B, S, D) basis
    masks, ``s`` (B, S), ``d`` (B, D), ``M`` (B, S, D), numpy arrays or
    tensors.  CUDA tensors are used where they lie; host arrays are copied
    to ``device`` (masks as bytes, M in float32 or float64 as given, else
    in float64, masses in float64).  The costs are read in their own dtype
    and widened exactly.

    Returns numpy arrays: status (B,) (``TREE``, ``COUNT``: not S + D - 1
    arcs, ``CYCLE``: S + D - 1 arcs that hold a cycle), the arc counts
    (B,), and for the trees nums (B, 4: max feasibility error, min flow,
    min reduced cost, objective), arcs (B, S + D - 1: flat cell indices in
    flat order) and their float64 flows (B, S + D - 1).  Rows of the last
    three for other statuses are undefined."""
    B, S, D = M.shape
    if S == 0 or D == 0:
        raise ValueError(f"certify: an empty transportation problem "
                         f"({S} x {D})")
    device = torch.device(device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    n1 = S + D - 1
    with _LOCK, torch.cuda.device(device):
        host, slots = [], []
        for k, (a, dtype) in enumerate(((Bm, np.bool_), (M, None),
                                        (s, np.float64), (d, np.float64))):
            if isinstance(a, torch.Tensor) and a.is_cuda:
                continue
            if isinstance(a, torch.Tensor):
                a = a.numpy()
            if dtype is None:
                dtype = a.dtype if _cost_dtype(a.dtype) else np.float64
            a = np.ascontiguousarray(a, dtype=dtype)
            host.append(a.view(np.uint8) if a.dtype == np.bool_ else a)
            slots.append(k)
        args = [Bm, M, s, d]
        for k, t in zip(slots, _upload(host, device)):
            args[k] = t
        mask, Mt, st, dt = args
        mask = mask.to(device)
        mask = (mask.view(torch.uint8) if mask.dtype == torch.bool
                else (mask != 0).view(torch.uint8)).contiguous()
        if not _cost_dtype(Mt.dtype):
            Mt = Mt.double()
        Mt = Mt.to(device).contiguous()
        st, dt = (t.to(device, torch.float64).contiguous() for t in (st, dt))
        f64 = int(Mt.dtype == torch.float64)
        status = torch.empty(B, dtype=torch.int32, device=device)
        n_arcs = torch.empty(B, dtype=torch.int64, device=device)
        nums = torch.empty(B, 4, dtype=torch.float64, device=device)
        arcs = torch.empty(B, n1, dtype=torch.int64, device=device)
        flows = torch.empty(B, n1, dtype=torch.float64, device=device)
        lib = _build.library()
        # a block's node and arc arrays go to global scratch where they do
        # not fit its shared memory
        per_block = lib.scx_certify_scratch_bytes(S, D, f64)
        if per_block < 0:
            _build.check(-per_block, "scx_certify_scratch_bytes")
        scratch = (torch.empty(B * per_block, dtype=torch.uint8,
                               device=device) if per_block else None)
        with trace.span("scx.certify_kernel", device):
            err = lib.scx_certify(
                mask.data_ptr(), Mt.data_ptr(), st.data_ptr(), dt.data_ptr(),
                None if scratch is None else scratch.data_ptr(), B, S, D,
                f64, status.data_ptr(), n_arcs.data_ptr(), nums.data_ptr(),
                arcs.data_ptr(), flows.data_ptr(),
                torch.cuda.current_stream(device).cuda_stream)
        _build.check(err, "scx_certify")
        _build.LAUNCHES["certify"] += 1
        trace.count("certify.device", B)
        return tuple(t.cpu().numpy() for t in (status, n_arcs, nums, arcs,
                                               flows))

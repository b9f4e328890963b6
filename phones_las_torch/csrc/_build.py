"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled for Hopper (``sm_90a``) by ``nvcc``, one
process per source, all started together, then linked into one shared
library with a plain C interface that ``ctypes`` loads. The sources
include no PyTorch header, so a build takes seconds, not minutes.

The library lands in ``csrc/build/`` (ignored by git), named by a hash
of the sources and the flags, so an edited source rebuilds at its first
use and an unchanged one loads at once. The build runs inside the first
kernel launch, never at import: the CPU tests import every module on a
machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# seconds the last build took in this process (0.0 when the library was
# already built); chip_smoke.py reports it
last_build_seconds = 0.0

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LSTM_FWD = (_P,) * 5 + (_I, _I, _I) + (_P,) * 10 + (_I, _I, _I, _F, _I, _I, _I, _I, _P, _P, _P, _P)
# C entry points: (argtypes) — every pointer and the stream are c_void_p,
# or ctypes would pass them as 32-bit ints and cut them
_SIGNATURES = {
    # x, B, S, basis, tail, mel, mel_range, logmel, energy, T, win, hop, nfft,
    # nmel, frame_tile, clocks, stream
    "plt_fused_logmel": (_P, _I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P),
    # xp0, xp1, mask, wh0, wh1, nd, rev_bits, wh_bf16, out0, out1, hprev0,
    # hprev1, cprev0, cprev1, hfin0, hfin1, cfin0, cfin1, T, B, U,
    # forget_bias, cluster, bt, ksplit, route, cut, ws, clocks, stream
    "plt_lstm_recurrence": _LSTM_FWD,
    "plt_lstm_residual": _LSTM_FWD,
    # U, nd, wh_bf16, cut, info[4]
    "plt_lstm_grid_info": (_I, _I, _I, _P, _P),
    # U, wh_bf16, save_res, cluster, bt, ksplit, resident, info[4]
    "plt_lstm_fwd_info": (_I,) * 7 + (_P,),
    # U, wh_bf16, cluster, bt, ksplit, resident, info[4]
    "plt_lstm_bwd_info": (_I,) * 6 + (_P,),
    # xp0, xp1, mask, wh0, wh1, whg0, whg1, wht0, wht1, hprev0, hprev1, cprev0, cprev1,
    # dout0, dout1, dhfin0, dhfin1, dcfin0, dcfin1, nd, rev_bits, wh_bf16,
    # dxp0, dxp1, fac0, fac1, dwh0, dwh1, partials, dwh_split, T, B, U,
    # forget_bias, cluster, bt, ksplit, route, npass, cuts, ws, ws_pass, clocks,
    # part_ms, stream
    "plt_lstm_bwd": (_P,) * 19 + (_I, _I, _I) + (_P,) * 7 + (_I, _I, _I, _I, _F)
                    + (_I,) * 5 + (_P, _P, ctypes.c_longlong, _P, _P, _P),
    # U, nd, wh_bf16, cut, info[5]
    "plt_lstm_bwd_grid_info": (_I, _I, _I, _P, _P),
    # keys, mem, mask, B, T, A, M, emb, V, E, wq, v, attn_w, AL, out_w,
    # out_b, cell_ptrs, n_cells, U, bos, eos, steps, cluster, layout, act, ws,
    # cut, tokens, info[4], clocks, stream
    "plt_greedy_decode": (_P, _P, _P, _I, _I, _I, _I, _P, _I, _I, _P, _P,
                          _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P),
}


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH): the port's CUDA kernels cannot be built on this machine"
    )


def sources() -> list:
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the library if no build of these sources exists → its path."""
    global last_build_seconds
    out = BUILD_DIR / f"libphones_las_torch_{_digest()}.so"
    if out.exists():
        last_build_seconds = 0.0
        return out
    nvcc = _nvcc()
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        cus = sorted(SRC_DIR.glob("*.cu"))
        objs = [Path(tmp) / (cu.stem + ".o") for cu in cus]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(cu), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for cu, obj in zip(cus, objs)
        ]
        logs = [p.communicate()[0] for p in procs]
        log = "".join(f"== {cu.name}\n{text}" for cu, text in zip(cus, logs))
        (BUILD_DIR / "build.log").write_text(log)
        failed = [cu.name for cu, p in zip(cus, procs) if p.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        tmp_so = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, "-shared", *[str(o) for o in objs], "-o", str(tmp_so)],
            capture_output=True, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        os.replace(tmp_so, out)  # atomic: a concurrent loader sees all or nothing
    last_build_seconds = time.perf_counter() - t0
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build (first use) and load the kernels' shared library."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.plt_error_string.argtypes = [ctypes.c_int]
    lib.plt_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, name: str) -> None:
    """Raise if a C entry returned a non-zero ``cudaError_t``."""
    if err != 0:
        msg = library().plt_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed: cudaError_t {err} ({msg})")

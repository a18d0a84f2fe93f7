"""Build the port's CUDA kernels with nvcc at first use and load them with
ctypes.

Every `end2end_tpu_torch/csrc/*.cu` file is compiled by its own nvcc
process, all started together, and the objects are linked into a single
shared library with a plain C interface (no PyTorch headers, so the build
takes seconds).  The library's file name carries a hash of the sources and
flags, so an edited source is rebuilt and a stale library is never loaded.
The build directory, `csrc/build/`, is ignored by git.

Nothing here runs at import time: `library()` builds on its first call and
raises if nvcc is missing or fails; no caller falls back to another path.
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

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C entry points: (argtypes); every one returns cudaGetLastError() as int.
_SIGNATURES = {
    # x, vals, idx, rows, v, k, stream
    "e2e_topk_f32": (_VP, _VP, _VP, _LL, _I, _I, _VP),
    # lpk, ck, lpb, il, inc, cls_map, state_in, bp, score, state_out,
    # t_max, n, ks, W, K, s_cap, blank, n_ctx, v, stream
    "e2e_beam_step_f32": (_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
                          _I, _I, _I, _I, _I, _I, _I, _I, _I, _VP),
    # lp, targets, il, tl, a_out, n_out, z_hat, norm_end2, t_max, n, v,
    # s_max, blank, every, states, threads, ring, tape, smem, stream
    "e2e_ctc_alpha_f32": (_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
                          _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _VP),
    # lp, targets, il, tl, a_in, n_in, z_hat, norm_end2, gamma, abuf, nbuf,
    # t_max, n, v, s_max, blank, every, states, stream
    "e2e_ctc_beta_f32": (_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
                         _VP, _I, _I, _I, _I, _I, _I, _I, _VP),
    # lp, gamma, targets, il, tl, g, out, t_max, n, v, s_max, blank, stream
    "e2e_ctc_grad_f32": (_VP, _VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I,
                         _I, _VP),
    # b_pl, l_pl, tape, rcum, n, t_max, up, stream
    "e2e_rnnt_alpha_f32": (_VP, _VP, _VP, _VP, _I, _I, _I, _VP),
    # b_pl, l_pl, tape, rcum, il, ul, z_small, z_off, gb, gl, n, t_max, up,
    # stream
    "e2e_rnnt_post_f32": (_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
                          _I, _I, _I, _VP),
    # h, w, b, b2, y, b_pl, l_pl, m, logs, R, J, V, Vp, blank, raw, stream
    "e2e_rnnt_joint_fwd": (_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _LL,
                           _I, _I, _I, _I, _I, _VP),
    # h, w, b, y, m, logs, gb, gl, dh, R, J, V, Vp, blank, stream
    "e2e_rnnt_joint_dh": (_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _LL,
                          _I, _I, _I, _I, _VP),
    # h, w, b, y, m, logs, gb, gl, out, ws, R, J, V, Vp, blank, splits,
    # stream
    "e2e_rnnt_joint_dw": (_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
                          _LL, _I, _I, _I, _I, _I, _VP),
    # J, info (int[6], int[5] for K12)
    "e2e_rnnt_joint_fwd_plan": (_I, _VP),
    "e2e_rnnt_joint_dh_plan": (_I, _VP),
    "e2e_rnnt_joint_dw_plan": (_I, _VP),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").is_file():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda): "
                       "the CUDA kernels cannot be built")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


@functools.cache
def library():
    """The loaded kernel library, built first if its sources changed.

    Returns `(lib, info)`: `lib` is the ctypes handle with argtypes set,
    `info` a dict with the library path, build seconds (0.0 when the cached
    build was reused) and nvcc's resource report (`-Xptxas -v`).
    """
    sources = _sources()
    path = BUILD_DIR / f"libe2e_kernels_{_digest(sources)}.so"
    info = {"path": str(path), "build_s": 0.0, "log": ""}
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            objs = [str(Path(tmp, src.stem + ".o")) for src in sources]
            cmds = [[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", obj]
                    for src, obj in zip(sources, objs)]
            procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
                     for cmd in cmds]
            info["log"] = "".join(p.communicate()[0] for p in procs)
            so = str(Path(tmp, "lib.so"))
            cmds.append([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", so, *objs])
            rcs = [p.returncode for p in procs]
            if not any(rcs):
                link = subprocess.run(cmds[-1], capture_output=True,
                                      text=True)
                info["log"] += link.stdout + link.stderr
                rcs.append(link.returncode)
            for cmd, rc in zip(cmds, rcs):
                if rc != 0:
                    raise RuntimeError(f"nvcc failed ({rc}):\n"
                                       f"{' '.join(cmd)}\n{info['log']}")
            os.replace(so, path)  # atomic: a concurrent build never sees half
        info["build_s"] = time.perf_counter() - t0
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib, info


def check(status: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")

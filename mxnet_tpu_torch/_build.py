"""Build and load the port's hand-written CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, which the
kernel's Python wrapper loads with ``ctypes``. No PyTorch header is
included, so a build takes seconds, not minutes. Libraries land in
``build/`` beside the package, named by a hash of the source, the shared
headers (``csrc/*.cuh``) and the flags, so an edited source or header
is rebuilt and an unchanged one is loaded as it is. Nothing is built at import: the first wrapper call on a CUDA
tensor builds its library, or :func:`build` builds several at once.

:func:`build_cubin` compiles a user's kernel source (``rtc``) the same
way into a cubin under ``build/rtc/``, named by a hash of the source and
the options, with the compiler's report beside it.

:func:`ptxas_resources` reads a build log's per-kernel registers and
spills; :func:`sass_counts` counts instructions of a built library's
machine code with the toolkit's ``cuobjdump -sass``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence

from .base import MXNetError

__all__ = ["build", "load", "build_log", "build_cubin", "cubin_path",
           "ptxas_resources", "cuobjdump", "sass_counts", "parse_sass_counts",
           "NVCC_FLAGS", "CUBIN_FLAGS"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
RTC_DIR = BUILD_DIR / "rtc"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
CUBIN_FLAGS = ("-cubin", "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise MXNetError(
            "nvcc not found (looked in %s and on PATH): the port's CUDA "
            "kernels are built from source at first use" % path)
    return found


def _target(source: str) -> Path:
    """The library path of ``source``, named by a hash of the source, the
    shared headers it may include (``csrc/*.cuh``) and the flags."""
    src = CSRC / source
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / ("%s-%s.so" % (src.stem, h.hexdigest()[:16]))


def build_log(source: str) -> str:
    """The compiler's output (``-Xptxas -v``: registers, shared memory
    and spills per kernel) from the build of ``source``, or ``""``."""
    log = _target(source).with_suffix(".log")
    return log.read_text() if log.exists() else ""


_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_PROPS = re.compile(r"Function properties for (\S+)")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")


def ptxas_resources(log: str) -> Dict[str, Dict[str, int]]:
    """Per kernel of a ``-Xptxas -v`` report, keyed by mangled name:
    ``registers``, ``stack`` (bytes), ``spill_stores`` and
    ``spill_loads`` (bytes)."""
    out: Dict[str, Dict[str, int]] = {}
    name = None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            name = m.group(1)
            out[name] = {}
            continue
        m = _PROPS.search(line)
        if m and m.group(1) != name:
            name = None           # a device function's report, not a kernel
            continue
        if name is None:
            continue
        m = _FRAME.search(line)
        if m:
            out[name].update(stack=int(m.group(1)),
                             spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = _REGS.search(line)
        if m:
            out[name]["registers"] = int(m.group(1))
    return out


def parse_sass_counts(sass: str,
                      opcodes: Sequence[str]) -> Dict[str, Dict[str, int]]:
    """Per kernel (``Function : <mangled name>`` sections of ``cuobjdump
    -sass``), how many instructions have each of ``opcodes`` as their
    opcode, modifiers aside (``HGMMA.64x128x16.F32.BF16`` counts as
    ``HGMMA``)."""
    pattern = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)")
    out: Dict[str, Dict[str, int]] = {}
    counts = None
    for line in sass.splitlines():
        head = line.strip()
        if head.startswith("Function : "):
            counts = out.setdefault(head[len("Function : "):].strip(),
                                    {op: 0 for op in opcodes})
            continue
        if counts is None:
            continue
        m = pattern.search(line)
        if m and m.group(1) in counts:
            counts[m.group(1)] += 1
    return out


def cuobjdump() -> Optional[str]:
    """The toolkit's ``cuobjdump``, beside ``nvcc`` or on PATH, or None
    where the toolkit has none."""
    tool = Path(_nvcc()).with_name("cuobjdump")
    return str(tool) if tool.exists() else shutil.which("cuobjdump")


def sass_counts(source: str,
                opcodes: Sequence[str]) -> Dict[str, Dict[str, int]]:
    """:func:`parse_sass_counts` of the built library of ``source``.
    Raises :class:`MXNetError` when the toolkit has no ``cuobjdump`` or
    it fails."""
    tool = cuobjdump()
    if tool is None:
        raise MXNetError("cuobjdump not found beside %s or on PATH"
                         % _nvcc())
    proc = subprocess.run([tool, "-sass", str(_target(source))],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        raise MXNetError("cuobjdump -sass %s failed (exit %d):\n%s"
                         % (source, proc.returncode, proc.stdout[-4000:]))
    return parse_sass_counts(proc.stdout, opcodes)


def build(sources: Sequence[str]) -> List[Path]:
    """Compile every source that has no up-to-date library yet, all
    ``nvcc`` processes started together; returns the library paths.
    Raises :class:`MXNetError` with the compiler's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = [_target(s) for s in sources]
    procs = []
    for src, out in zip(sources, targets):
        if out.exists():
            continue
        tmp = out.with_name("%s.%d.tmp" % (out.name, os.getpid()))
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        procs.append((src, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for src, out, tmp, proc in procs:
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append("%s (nvcc exit %d):\n%s"
                          % (src, proc.returncode, log))
            continue
        os.replace(tmp, out)     # atomic: a reader never sees half a file
    if failed:
        raise MXNetError("CUDA kernel build failed: " + "\n".join(failed))
    return targets


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if needed."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build([source])[0]))
            _libs[source] = lib
        return lib


def cubin_path(source_text: str, options: Sequence[str] = ()) -> Path:
    """Where :func:`build_cubin` puts the cubin of this source and these
    options: ``build/rtc/<sha256 of source and options>.cubin``."""
    h = hashlib.sha256(source_text.encode())
    h.update("\0".join((*CUBIN_FLAGS, *options)).encode())
    return RTC_DIR / (h.hexdigest() + ".cubin")


def build_cubin(source_text: str, options: Sequence[str] = ()) -> Path:
    """Compile a CUDA source string for ``sm_90a`` into a cubin (the
    ``rtc`` tier), unless an up-to-date one exists; returns its path.
    The source is kept beside it as ``.cu`` and the compiler's output
    (``-Xptxas -v``) as ``.log``. Safe to call from several threads or
    processes at once: each compiles into its own temporary file and
    renames it into place. Raises :class:`MXNetError` when ``nvcc`` is
    missing or fails, with the compiler's output."""
    out = cubin_path(source_text, options)
    if out.exists():
        return out
    nvcc = _nvcc()
    RTC_DIR.mkdir(parents=True, exist_ok=True)
    tag = "%d.%d.tmp" % (os.getpid(), threading.get_ident())
    src = out.with_suffix(".cu")
    tmp_src = src.with_name("%s.%s.cu" % (src.stem, tag))
    tmp_src.write_text(source_text)
    os.replace(tmp_src, src)
    tmp = out.with_name("%s.%s" % (out.name, tag))
    proc = subprocess.run([nvcc, *CUBIN_FLAGS, *options, "-o", str(tmp),
                           str(src)], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    out.with_suffix(".log").write_text(proc.stdout)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise MXNetError("user CUDA kernel build failed (nvcc exit %d, "
                         "source %s):\n%s" % (proc.returncode, src,
                                               proc.stdout))
    os.replace(tmp, out)     # atomic: a reader never sees half a file
    return out

"""Build the native host runtime (``hostops.cc``) with the system compiler.

The library is built at first use into ``flacx_torch/_build/host-<hash>/``,
the hash taken over the source, the flags and the host's name and
architecture: it is built on the machine it runs on and targets the local
ISA (``-march=native``, or the portable build where the compiler refuses
that), so a build directory copied to another machine is not reused.  A failed build raises with the
compiler's output.
"""

from __future__ import annotations

import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

HERE = Path(__file__).parent
SOURCE = HERE / "hostops.cc"
BUILD_ROOT = HERE.parent / "_build"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(f"{platform.node()} {platform.machine()}".encode())
    h.update(SOURCE.read_bytes())
    return BUILD_ROOT / f"host-{h.hexdigest()[:16]}" / "libhostops.so"


def build() -> Path:
    """Compile ``hostops.cc`` unless its library is built; returns its
    path."""
    out = library_path()
    with _lock:
        if out.exists():
            return out
        cxx = (shutil.which("c++") or shutil.which("g++")
               or shutil.which("clang++"))
        if cxx is None:
            raise RuntimeError("flacx_torch: no C++ compiler found to build "
                               "the native host runtime")
        out.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
        os.close(fd)
        logs = []
        for extra in (["-march=native"], []):
            proc = subprocess.run([cxx, *FLAGS, *extra, str(SOURCE), "-o",
                                   tmp], capture_output=True, text=True)
            if proc.returncode == 0:
                os.replace(tmp, out)
                return out
            logs.append(f"--- {' '.join(proc.args)} ---\n{proc.stdout}"
                        f"{proc.stderr}")
        os.unlink(tmp)
        try:
            out.parent.rmdir()
        except OSError:
            pass
        raise RuntimeError("flacx_torch: native host runtime build failed\n"
                           + "\n".join(logs))


if __name__ == "__main__":
    print(build())

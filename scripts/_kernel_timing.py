"""What the kernel timing scripts share: a built library's instruction
counts, another build of a kernel from a changed copy of its source (an
ablation, or another commit's), and a call in which a wrapper module
launches that build.  Needs ``nvcc`` and ``cuobjdump``, so it runs on the
card's machine; import it from a script in this directory."""
from __future__ import annotations

import collections
import re
import subprocess
import time
from pathlib import Path

from repro_torch.kernels import build

# tensor-core products (Hopper's and the older warp-level ones), fp32
# multiply-adds, and WARPGROUP.DEPBAR, a wait for the products in flight
SASS_OPS = ("HGMMA", "HMMA", "FFMA", "DEPBAR")


def sass_counts(path) -> dict:
    """Each kernel function of the library at ``path``: its count of each of
    SASS_OPS and of all instructions, from ``cuobjdump -sass``."""
    tool = build.nvcc().parent / "cuobjdump"
    proc = subprocess.run([str(tool), "-sass", str(path)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"cuobjdump failed: {proc.stderr}")
    counts: dict = {}
    name = None
    for line in proc.stdout.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = collections.Counter()
        elif name and re.search(r"/\*[0-9a-f]{4,}\*/", line):
            counts[name]["all"] += 1
            for op in SASS_OPS:
                if re.search(rf"\b{op}\b", line):
                    counts[name][op] += 1
    return counts


def variant_library(lib: build.KernelLibrary, name: str,
                    source: str) -> build.KernelLibrary:
    """A library with ``lib``'s C entries, built from ``source`` into
    ``build/kernels/variants/``; prints what ``nvcc`` reported and the
    SASS counts of each of its kernels."""
    stem = lib.source.stem
    out_dir = build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    out = out_dir / f"{stem}_{name}.so"
    t0 = time.perf_counter()
    proc = subprocess.run([str(build.nvcc()), *build.NVCC_FLAGS, "-o",
                           str(out), str(Path(source).resolve())],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on variant {name}:\n{proc.stdout}"
                           f"{proc.stderr}")
    print(f"variant {name} ({source}) built in {time.perf_counter() - t0!r} s")
    print((proc.stdout + proc.stderr).strip())
    for fn, n in sass_counts(out).items():
        print(f"variant {name} sass {fn}: {dict(n)}")
    variant = build.KernelLibrary(stem, lib.entries)
    variant.build_info = {"seconds": 0.0, "log": "", "path": str(out)}
    return variant


def with_library(module, attr: str, lib, fn):
    """``fn()`` with ``module.<attr>`` set to ``lib``, so that the module's
    wrappers launch ``lib``'s kernels; the module's own library after."""
    kept = getattr(module, attr)
    setattr(module, attr, lib)
    try:
        return fn()
    finally:
        setattr(module, attr, kept)

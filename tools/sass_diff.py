#!/usr/bin/env python3
"""Compare the machine code of one CUDA source in two checkouts.

    python3 tools/sass_diff.py OTHER_CHECKOUT fused_ffn_w8a8 [NAME ...]

builds `tutel_tpu_torch/csrc/<NAME>.cu` of this checkout and of
OTHER_CHECKOUT (with its own headers) with this checkout's nvcc flags,
disassembles both with `cuobjdump -sass`, and prints one JSON line per
kernel: its instructions here and there, whether the two instruction
streams are identical (addresses and encodings left out), and the first
instruction where they differ.
Needs nvcc and cuobjdump (the CUDA toolkit), no card.
"""

import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tutel_tpu_torch.csrc import build  # noqa: E402


def kernel_name(mangled):
    """The mangled name with an anonymous namespace's (which holds a hash of
    the source's path) replaced by `(anonymous)`."""
    m = re.match(r"_ZN(\d+)", mangled)
    if m:
        end = m.end() + int(m.group(1))
        if mangled[m.end():end].startswith("_GLOBAL__N_"):
            return "_ZN(anonymous)" + mangled[end:]
    return mangled


def sass(root, name, tag):
    """{kernel: [instruction text]} of csrc/<name>.cu under `root`."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = build.BUILD_DIR / f"sass-{tag}-{name}.{os.getpid()}.so"
    src = os.path.join(root, "tutel_tpu_torch", "csrc", f"{name}.cu")
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib), src],
                   check=True, capture_output=True, text=True)
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    lib.unlink()
    out = {}
    for part in re.split(r"\n\s*Function : ", text)[1:]:
        out[kernel_name(part.split(None, 1)[0])] = [
            " ".join(m.group(1).split()) for m in
            re.finditer(r"/\*[0-9a-f]{4,}\*/\s+([^;]*;)", part)]
    return out


def main(argv):
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    other, names = argv[0], argv[1:]
    same = True
    for name in names:
        here, there = sass(ROOT, name, "here"), sass(other, name, "there")
        for kernel in sorted(set(here) | set(there)):
            a, b = here.get(kernel), there.get(kernel)
            same &= a == b
            first = next((i for i, (u, v) in enumerate(zip(a or (), b or ()))
                          if u != v), None)
            print(json.dumps({"source": name, "kernel": kernel,
                              "instructions": len(a or ()),
                              "other_instructions": len(b or ()),
                              "identical": a == b,
                              "first_difference": None if first is None else
                              [first, a[first], b[first]]}), flush=True)
    print(json.dumps({"all_identical": same}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

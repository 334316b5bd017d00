"""Compare what two versions of the flash attention source compile to.

    python3 tools/sass_compare.py OLD.cu [NEW.cu]

Builds both sources with the port's ``nvcc`` flags into ``build/sass/``,
dumps each library's SASS with the toolkit's ``cuobjdump -sass`` and, for
every ``flash_kernel`` instantiation of OLD (one per head width), compares
its instructions with NEW's instantiation of the same head width without
a soft-cap (``flash_kernel<HD, false>``; NEW defaults to the shipped
``csrc/flash_attention.cu``). Addresses and encodings are dropped, the
instruction text is compared line by line. Prints one JSON line per head
width: the instruction counts, whether they are equal, and the first
differing line. Exits 1 if any differs. Needs the CUDA toolkit (the
machine with the card); the card itself is not used.
"""

import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.kernels.build import NVCC_FLAGS, find_nvcc  # noqa: E402

OUT = os.path.join(ROOT, "build", "sass")
SHIPPED = os.path.join(ROOT, "src", "repro_torch", "kernels",
                       "flash_attention", "csrc", "flash_attention.cu")


def sass(src: str, tag: str) -> dict:
    """{(head width, capped): [instruction, ...]} of ``src``'s
    ``flash_kernel`` instantiations."""
    os.makedirs(OUT, exist_ok=True)
    lib = os.path.join(OUT, f"lib{tag}.so")
    subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", lib, src], check=True,
                   capture_output=True)
    tool = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", lib], check=True,
                          capture_output=True, text=True).stdout
    out, key = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            hd = re.search(r"flash_kernelILi(\d+)E(Lb([01])E)?", name)
            key = ((int(hd.group(1)), hd.group(3) == "1")
                   if hd and "wide" not in name else None)
            if key:
                out[key] = []
            continue
        ins = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;", line)
        if key and ins:
            out[key].append(ins.group(1))
    return out


def main(old: str, new: str = SHIPPED) -> int:
    a, b = sass(old, "old"), sass(new, "new")
    bad = 0
    for (hd, capped), ins in sorted(a.items()):
        got = b.get((hd, False), [])
        diff = next((i for i, (x, y) in enumerate(zip(ins, got)) if x != y),
                    None if len(ins) == len(got) else min(len(ins), len(got)))
        same = diff is None
        bad += not same
        print(json.dumps({"head_width": hd, "old_instructions": len(ins),
                          "new_instructions": len(got), "identical": same,
                          "first_diff": None if same else
                          [ins[diff] if diff < len(ins) else None,
                           got[diff] if diff < len(got) else None]}),
              flush=True)
    return 1 if bad or not a else 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))

"""Compare what two versions of a kernel source compile to.

    python3 tools/sass_compare.py OLD.cu [NEW.cu]

Builds both sources with the port's ``nvcc`` flags into ``build/sass/``,
dumps each library's SASS with the toolkit's ``cuobjdump -sass`` and, for
every f32 kernel instantiation of OLD, compares its instructions with NEW's
instantiation of the same template arguments. The kernels are the flash
attention's (``flash_kernel<HD, CAP>``, ``flash_kernel_wide<CAP>``), the
SSD scan's (``ssd_scan_kernel<N, HP[, T]>``) and the selective scan's
(``selective_scan_kernel<N[, T]>``): an element type ``T = float`` in NEW
matches OLD's instantiation without one, and an OLD flash kernel without a
soft-cap flag matches NEW's ``CAP = false``. Every other kernel (the bf16
instantiations, ``flash_bf16_hopper``, ``ssd_bf16_hopper``, and
``flash_attention_bwd.cu``'s ``flash_bwd_kernel`` and ``flash_bwd_dsum``)
is compared with NEW's function of the same symbol, the anonymous
namespace's name (which carries the source's path) dropped; one that only
OLD or only NEW has is listed as such and not compared. NEW defaults to
the shipped source of the same file name under
``src/repro_torch/kernels/``. Addresses and encodings are dropped, the
instruction text is compared line by line.
Prints one JSON line per function: the instruction counts, whether they
are equal, and the first differing line. Exits 1 if any compared function
differs or none was compared. Needs the CUDA toolkit (the
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
KERNELS = os.path.join(ROOT, "src", "repro_torch", "kernels")
SHIPPED = {"flash_attention.cu": "flash_attention",
           "flash_attention_bwd.cu": "flash_attention",
           "ssd_scan.cu": "ssd_scan", "selective_scan.cu": "mamba_scan"}
NAME = re.compile(r"\d+(flash_kernel_wide|flash_kernel_bf16|flash_kernel|"
                  r"ssd_scan_kernel|selective_scan_kernel)I(.*?)EE")


def key_of(symbol: str):
    """(kernel, template arguments) of an f32 kernel instantiation, with an
    element type ``float`` dropped; None for a bf16 one or another symbol."""
    m = NAME.search(symbol)
    if not m or m.group(1) == "flash_kernel_bf16" or "bfloat16" in m.group(2):
        return None
    return m.group(1), re.sub(r"Ef$", "", m.group(2))


def plain_symbol(symbol: str) -> str:
    """``symbol`` without its anonymous namespace's length-prefixed name."""
    at = symbol.find("_GLOBAL__N")
    if at < 0:
        return symbol
    start = at
    while start > 0 and symbol[start - 1].isdigit():
        start -= 1
    return symbol[:start] + symbol[at + int(symbol[start:at]):]


def sass(src: str, tag: str) -> dict:
    """{key: [instruction, ...]} of ``src``'s kernels: (kernel, template
    arguments) for an f32 instantiation, ("symbol", plain symbol) for any
    other kernel."""
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
            key = key_of(m.group(1)) or ("symbol", plain_symbol(m.group(1)))
            out[key] = []
            continue
        ins = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;", line)
        if key and ins:
            out[key].append(ins.group(1))
    return out


def main(old: str, new: str = None) -> int:
    base = os.path.basename(old)
    new = new or os.path.join(KERNELS, SHIPPED[base], "csrc", base)
    a, b = sass(old, "old"), sass(new, "new")
    bad = compared = 0
    for key in sorted(set(a) ^ set(b)):
        if key[0] == "symbol":
            print(json.dumps({"source": base, "kernel": key[1],
                              "only_in": "old" if key in a else "new"}),
                  flush=True)
    for (kernel, args), ins in sorted(a.items()):
        if kernel == "symbol" and (kernel, args) not in b:
            continue
        got = b.get((kernel, args))
        if got is None and kernel == "flash_kernel":   # OLD without a cap
            got = b.get((kernel, args + "ELb0"), [])
        got = got or []
        diff = next((i for i, (x, y) in enumerate(zip(ins, got)) if x != y),
                    None if len(ins) == len(got) else min(len(ins), len(got)))
        same = diff is None
        bad += not same
        compared += 1
        print(json.dumps({"source": base, "kernel": kernel,
                          "template_args": args,
                          "old_instructions": len(ins),
                          "new_instructions": len(got), "identical": same,
                          "first_diff": None if same else
                          [ins[diff] if diff < len(ins) else None,
                           got[diff] if diff < len(got) else None]}),
              flush=True)
    return 1 if bad or not compared else 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))

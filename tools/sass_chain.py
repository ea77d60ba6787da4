#!/usr/bin/env python3
"""Count the dependent instructions in a kernel's hot loop, from its SASS.

    python3 tools/sass_chain.py LIB.so KERNEL [--bits N] [--dump FILE]

LIB.so is a kernel library built from csrc/ (kanzi_tpu_torch/build/ after a
first call; `cuobjdump` from the CUDA toolkit reads its SASS). KERNEL is a
substring of the kernel's mangled name, e.g. fpaq_encode_kernel. For each
loop of the kernel (a backward branch and its target), the script prints
its instruction count and the longest path of register and predicate
dependencies through one pass of its body, read in address order as
straight-line code (forward branches inside the body are not followed, so
both sides of a branch count). The hot loop is the innermost loop with the
most IMAD.WIDE.U32 instructions (the FPAQ coders' split multiply); --bits
gives the coded bits one pass of it takes (the source's unrolling: 128 in
a loop over 16-byte groups, 8 in a loop over bytes), for the counts per
bit, and its opcode mix. It comes last, as one JSON line; --dump writes
its SASS to FILE.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys

INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?);")
REG = re.compile(r"\b(U?R\d+|U?P\d+)(\.64)?\b")
LABELS: dict[str, int] = {}        # a label of the SASS listing -> its address
NO_DEST = ("ST", "STG", "STS", "STL", "RED", "ATOM", "BRA", "BAR", "EXIT", "RET",
           "CALL", "BSYNC", "BSSY", "WARPSYNC", "NOP", "MEMBAR", "DEPBAR", "ERRBAR",
           "CCTL", "YIELD", "JMP", "BPT")


def cuobjdump() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "cuobjdump")
    return path if os.path.exists(path) else (shutil.which("cuobjdump") or "cuobjdump")


def kernel_sass(lib: str, kernel: str) -> list[tuple[int, str]]:
    """(address, instruction text) of the first function whose name holds
    `kernel`."""
    text = subprocess.run([cuobjdump(), "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    out, inside, labels = [], False, []
    for line in text.splitlines():
        if "Function :" in line:
            if inside:
                break
            inside = kernel in line
            continue
        if not inside:
            continue
        lab = re.match(r"\s*(\.L_x_\d+):", line)
        if lab:
            labels.append(lab.group(1))
        m = INSN.search(line)
        if m:
            addr = int(m.group(1), 16)
            for name in labels:
                LABELS[name] = addr
            labels = []
            out.append((addr, m.group(2).strip()))
    if not out:
        raise SystemExit(f"sass_chain: no function matching {kernel!r} in {lib}")
    return out


def regs(token: str) -> list[str]:
    """Registers named by one operand (a .64 pair names two)."""
    found = []
    for name, wide in REG.findall(token):
        if name in ("RZ", "PT", "URZ", "UPT"):
            continue
        found.append(name)
        if wide and name[-1].isdigit():
            base = name.rstrip("0123456789")
            found.append(f"{base}{int(name[len(base):]) + 1}")
    return found


def parse(insn: str) -> tuple[str, list[str], list[str]]:
    """(opcode, destinations, sources) of one SASS instruction."""
    guard = []
    if insn.startswith("@"):
        g, insn = insn.split(None, 1)
        guard = regs(g)
    parts = insn.split(None, 1)
    op = parts[0]
    ops = [o.strip() for o in parts[1].split(",")] if len(parts) > 1 else []
    base = op.split(".")[0]
    dests: list[str] = []
    srcs = list(guard)
    for i, o in enumerate(ops):
        names = regs(o)
        is_dest = (base not in NO_DEST and "[" not in o
                   and (i == 0 or (i == 1 and o.lstrip("!").startswith("P"))))
        if is_dest and i == 0 and (".WIDE" in op or op.startswith(("IMAD.WIDE", "LDS.64",
                                                                    "LDG.E.64"))):
            n = names[0] if names else None
            if n and n[-1].isdigit():
                b = n.rstrip("0123456789")
                names = [n, f"{b}{int(n[len(b):]) + 1}"]
        if ".128" in op and i == 0 and base.startswith("LD") and names:
            b = names[0].rstrip("0123456789")
            names = [f"{b}{int(names[0][len(b):]) + j}" for j in range(4)]
        (dests if is_dest else srcs).extend(names)
    if guard:
        srcs.extend(dests)          # a predicated write keeps the old value
    return op, dests, srcs


def loops(sass: list[tuple[int, str]]) -> list[tuple[int, int]]:
    """(first, last) instruction indices of each backward branch's body."""
    index = {a: i for i, (a, _) in enumerate(sass)}
    out = []
    for i, (addr, insn) in enumerate(sass):
        m = re.search(r"\bBRA\b.*?(0x[0-9a-f]+|\.L_x_\d+)", insn)
        if m:
            t = m.group(1)
            target = int(t, 16) if t.startswith("0x") else LABELS.get(t, addr + 1)
            if target <= addr and target in index:
                out.append((index[target], i))
    return out


def chain(body: list[str]) -> int:
    """Longest dependency path, in instructions, through one pass."""
    depth: dict[str, int] = {}
    longest = 0
    for insn in body:
        _, dests, srcs = parse(insn)
        d = 1 + max((depth.get(r, 0) for r in srcs), default=0)
        for r in dests:
            depth[r] = d
        longest = max(longest, d)
    return longest


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("lib")
    ap.add_argument("kernel")
    ap.add_argument("--bits", type=int, help="coded bits one pass of the hot loop takes")
    ap.add_argument("--dump", help="write the hot loop's SASS to this file")
    args = ap.parse_args()
    sass = kernel_sass(args.lib, args.kernel)
    spans = loops(sass)
    rows = []
    for first, last in spans:
        body = [insn for _, insn in sass[first:last + 1]]
        rows.append(dict(first=hex(sass[first][0]), last=hex(sass[last][0]),
                         instructions=len(body), chain=chain(body),
                         wide=sum(1 for b in body if parse(b)[0] == "IMAD.WIDE.U32"),
                         innermost=not any(first <= f and l <= last and (f, l) != (first, last)
                                           for f, l in spans),
                         sass=body))
        r = rows[-1]
        print(f"loop {r['first']}-{r['last']}: {r['instructions']} instructions, "
              f"{r['wide']} IMAD.WIDE.U32, longest dependency path {r['chain']}"
              f"{' (innermost)' if r['innermost'] else ''}", flush=True)
    inner = sorted((r for r in rows if r["innermost"]), key=lambda r: r["wide"])
    hot = inner[-1] if inner else None
    if hot:
        # opcodes without modifiers: SEL, LOP3, IADD3, SHF, ISETP, LEA run on
        # the 16-lane integer pipe, IMAD on the multiply-add pipe
        mix: dict[str, int] = {}
        for insn in hot["sass"]:
            op = parse(insn)[0].split(".")[0]
            mix[op] = mix.get(op, 0) + 1
        hot["mix"] = dict(sorted(mix.items(), key=lambda kv: -kv[1]))
    if hot and args.bits:
        hot.update(bits=args.bits, chain_per_bit=hot["chain"] / args.bits,
                   instructions_per_bit=hot["instructions"] / args.bits)
    if hot and args.dump:
        with open(args.dump, "w") as fh:
            fh.write("\n".join(hot["sass"]) + "\n")
    for r in rows:
        del r["sass"]
    print(json.dumps(dict(lib=args.lib, kernel=args.kernel, total=len(sass),
                          hot_loop=hot)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""A/B timing of phovo_tpu_torch's level kernels K-TR (fused_tr_batch.cu)
and K-GN (fused_gn_batch.cu, with K-GN-bi) on one NVIDIA GPU: two source
trees against each other, or this tree's cluster sizes against each other.

    python3 tools/ktr_ab.py OTHER_TREE   # the A/B against another tree
    python3 tools/ktr_ab.py --sweep      # every cluster size, this tree

OTHER_TREE is another checkout of the repository (an unpacked `git
archive` of another commit). The A/B compiles fused_tr_batch.cu and
fused_gn_batch.cu of this tree and of OTHER_TREE, each alone into its own
library with this tree's nvcc flags, prints ptxas's register, stack and
spill summary of each (this tree's one-block and cluster instantiations
apart), holds the machine code (cuobjdump -sass) of each of OTHER_TREE's
kernels against this tree's one-block instantiation of the same variant,
instruction by instruction, binds each tree's C entry from the `extern "C"`
signature in its own source (a parameter the other tree lacks, such as
`cluster`, is left out of its call), and times each launch of
chip_smoke.cluster_workloads (K-TR, K-GN and K-GN-bi at B = 1 on a
480x640 level; K-TR and K-GN on 16 targets of a shared keyframe; the
ceres chain's five levels and the bench chain's three at 256 pairs) on
the same inputs in turns (other, this, this, other), by CUDA events over
repeated launches after a warm-up. The sweep launches this tree's kernels
through their C entries at 1, 2, 4, 8 and 16 blocks a pair, in turns
(1 ... 16, 16 ... 1; the rule's size marked), with each size's largest
state difference from one block a pair: this is how
fused_batch.cluster_size's rule was chosen. Prints every time with the
card's name and power limit.
"""

from __future__ import annotations

import ctypes
import importlib.util
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

REPEATS = 20
SWEEP = (1, 2, 4, 8, 16)


def chip_smoke():
    """chip_smoke.py as a module (it runs its phases only as a script)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


# a level kernel's template arguments in its mangled name, e.g. Lb1ELi0E
# (bilinear, loss 0); in a tree whose kernels take kCluster, the last one
# is it (Lb0E one block a pair, Lb1E a cluster)
TEMPLATE_ARGS = re.compile(r"kernelI((?:L[a-z]+\d+E)+)EEv")


def template_args(name: str) -> tuple:
    m = TEMPLATE_ARGS.search(name)
    return tuple(re.findall(r"L[a-z]+\d+E", m[1])) if m else ()


def ptxas_kernels(stderr: str) -> dict:
    """{mangled kernel name: (registers, stack bytes, spill bytes)} from
    ptxas -v."""
    kernels = {}
    for chunk in stderr.split("Compiling entry function '")[1:]:
        name = chunk.split("'", 1)[0]
        regs = re.search(r"Used (\d+) registers", chunk)
        stack = re.search(r"(\d+) bytes stack frame", chunk)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", chunk)
        kernels[name] = (int(regs[1]) if regs else -1, int(stack[1]) if stack else 0,
                         int(spill[1]) + int(spill[2]) if spill else 0)
    return kernels


def ptxas_summary(kernels: dict, clustered: bool) -> str:
    """Registers (range), the largest stack frame and spill stores plus
    loads over the kernels, and with a cluster layout (clustered) for its
    one-block and cluster instantiations apart."""
    def line(values):
        regs = [r for r, _, _ in values]
        return (f"{len(regs)} kernels, {min(regs)}-{max(regs)} registers, stack <= "
                f"{max(s for _, s, _ in values)} B, spills <= {max(sp for _, _, sp in values)} B")

    parts = [line(list(kernels.values()))]
    if clustered:
        for label, flag in (("one-block", "Lb0E"), ("cluster", "Lb1E")):
            parts.append(f"{label}: " + line([v for n, v in kernels.items() if template_args(n)[-1:] == (flag,)]))
    return "; ".join(parts)


def sass(lib: Path) -> dict:
    """{mangled kernel name: its SASS instructions, addresses and
    encodings dropped} of a library, by cuobjdump."""
    from phovo_tpu_torch.ops import _build

    out = subprocess.run([str(Path(_build.nvcc()).with_name("cuobjdump")), "-sass", str(lib)],
                         capture_output=True, text=True, check=True).stdout
    code, name = {}, None
    for line in out.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            name = head[1]
            code[name] = []
            continue
        ins = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if name and ins:
            code[name].append(ins[1])
    return code


def compare_sass(other: tuple, this: tuple, label: str) -> None:
    """other, this: (ptxas_kernels, sass, clustered) of one source in the
    two trees. Prints how many of the other tree's kernels have a twin here
    with the same instructions: the same variant, one block a pair when
    only this tree has the cluster layout; and, for those that differ, the
    registers of the other tree's kernel, of its twin and of this tree's
    cluster instantiation of the variant."""
    (regs_o, code_o, clustered_o), (regs_t, code_t, clustered_t) = other, this
    by_args = {template_args(n): n for n in code_t}
    same, differ = 0, []
    for name, code in code_o.items():
        args = template_args(name)
        extend = clustered_t and not clustered_o
        twin = by_args.get(args + (("Lb0E",) if extend else ()))
        if twin is not None and code_t[twin] == code:
            same += 1
            continue
        many = by_args.get(args + ("Lb1E",)) if extend else None
        differ.append(f"{''.join(args)} {regs_o[name][0]} vs {regs_t[twin][0] if twin else '-'}"
                      + (f" (cluster {regs_t[many][0]})" if many else ""))
    print(f"SASS {label}: {same} of {len(code_o)} of the other tree's kernels have a twin in this tree with the "
          f"same instructions" + (f"; registers of the others, other tree vs this: {'; '.join(differ)}"
                                  if differ else ""))


def build(smoke, tree: Path, kind: str, out: Path):
    """nvcc one level kernel's source of tree alone into out; returns (its
    bound C entry, the entry's parameter names, (ptxas_kernels, sass,
    whether its kernels take kCluster, nvcc's seconds))."""
    from phovo_tpu_torch.ops import _build

    csrc = tree / "phovo_tpu_torch" / "csrc"
    source, name = smoke.LEVEL_ENTRIES[kind]
    cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-I", str(csrc), "-o", str(out),
           str(csrc / source)]
    start = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {csrc / source}:\n{proc.stderr}")
    seconds = time.perf_counter() - start
    params = _build.entry_signatures((csrc / source).read_text())[name]
    fn = getattr(ctypes.CDLL(str(out)), name)
    fn.argtypes = [t for _, t in params]
    fn.restype = ctypes.c_int
    clustered = "bool kCluster" in (csrc / source).read_text()
    return fn, [n for n, _ in params], (ptxas_kernels(proc.stderr), sass(out), clustered, seconds)


def print_totals(rows, columns, card) -> None:
    """rows: [(group, time per column)]; prints each group's sums."""
    totals = {}
    for group, *times in rows:
        acc = totals.setdefault(group, [0.0] * len(times))
        for k, t in enumerate(times):
            acc[k] += t
    for group, sums in totals.items():
        print(f"total {group}: " + ", ".join(f"{c} {t:.4f}" for c, t in zip(columns, sums)) + f" ms [{card}]")


def ab(smoke, cases, other: Path, card: str) -> None:
    out = ROOT / "build" / "phovo_tpu_torch"
    out.mkdir(parents=True, exist_ok=True)
    trees = {"other": other, "this": ROOT}
    with ThreadPoolExecutor(4) as pool:
        futures = {(key, kind): pool.submit(build, smoke, tree, kind, out / f"ktr_ab_{key}_{kind}.so")
                   for key, tree in trees.items() for kind in smoke.LEVEL_ENTRIES}
    entries = {k: f.result() for k, f in futures.items()}
    for (key, kind), (_, names, (kernels, _, clustered, seconds)) in entries.items():
        print(f"ptxas {key} tree {smoke.LEVEL_ENTRIES[kind][0]}: {ptxas_summary(kernels, clustered)}; C entry "
              f"parameters {len(names)}; nvcc {seconds:.1f} s")
    for kind in smoke.LEVEL_ENTRIES:
        compare_sass(entries["other", kind][2][:3], entries["this", kind][2][:3], smoke.LEVEL_ENTRIES[kind][0])
    rows = []
    for group, label, kind, args, kw in cases:
        runs = {key: smoke.entry_launcher(*entries[key, kind][:2], kind, args, kw) for key in trees}
        times = {key: [] for key in trees}
        for key in ("other", "this", "this", "other"):
            times[key].append(smoke.cuda_ms(runs[key][0], REPEATS))
        diff = float((runs["other"][1] - runs["this"][1]).abs().max())
        n_it = int((runs["other"][2][:, 0] != runs["this"][2][:, 0]).sum())
        o, t = (sum(times[k]) / 2 for k in ("other", "this"))
        rows.append((group, o, t))
        print(f"{group}, {label}: other tree {times['other'][0]:.4f}, {times['other'][1]:.4f} ms; this tree "
              f"{times['this'][0]:.4f}, {times['this'][1]:.4f} ms; this / other {t / o:.4f}; max|state diff| "
              f"{diff:.3e}, {n_it} pairs with other iteration counts [{card}]")
    print_totals(rows, ("other tree", "this tree"), card)


def sweep(smoke, cases, card: str) -> None:
    from phovo_tpu_torch.ops import _build
    from phovo_tpu_torch.ops.fused_batch import cluster_size

    lib = _build.library()
    rows = []
    for group, label, kind, args, kw in cases:
        fn, names = getattr(lib, smoke.LEVEL_ENTRIES[kind][1]), smoke.entry_names(kind)
        runs = {}
        for c in SWEEP:
            run = smoke.entry_launcher(fn, names, kind, args, kw, c)
            try:
                run[0]()
            except RuntimeError as err:
                print(f"{group}, {label}: {c} blocks a pair refused ({err})")
                continue
            runs[c] = run
        times = {c: [] for c in runs}
        for c in [*runs, *reversed(runs)]:
            times[c].append(smoke.cuda_ms(runs[c][0], REPEATS))
        parts = []
        for c, (_, states, diag) in runs.items():
            diff = float((states - runs[1][1]).abs().max())
            n_it = int((diag[:, 0] != runs[1][2][:, 0]).sum())
            mark = " (rule)" if c == cluster_size(kw["H"], kw["W"]) else ""
            parts.append(f"C = {c}{mark} {sum(times[c]) / 2:.4f} ms (max|diff| {diff:.1e}, {n_it} its differ)")
        rows.append((group, *(sum(times.get(c, (0.0,))) / 2 for c in SWEEP)))
        print(f"{group}, {label}: " + "; ".join(parts) + f" [{card}]")
    print_totals(rows, [f"C = {c}" for c in SWEEP], card)


def main() -> int:
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    from phovo_tpu_torch.ops import _build, se3

    smoke = chip_smoke()
    _build.library()
    frames, _ = smoke.keyframe_frames(se3)
    cases = smoke.cluster_workloads(torch.device("cuda", 0), frames[:smoke.KF_CHUNK + 1])
    if sys.argv[1] == "--sweep":
        sweep(smoke, cases, card)
    else:
        ab(smoke, cases, Path(sys.argv[1]).resolve(), card)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""A/B timing of phovo_tpu_torch's level kernels K-TR (fused_tr_batch.cu),
K-GN (fused_gn_batch.cu, with K-GN-bi), K-IC (ic_gn_batch.cu) and K-ICpre
(ic_precompute.cu), and of the one-linearization kernel K-LIN
(fused_lin.cu), on one NVIDIA GPU: two source trees against each other,
or this tree's layouts (cluster sizes, K-IC's resident packs, K-LIN's
split) against each other.

    python3 tools/ktr_ab.py OTHER_TREE [--kernels tr,gn,lin,ic,icpre]   # the A/B
    python3 tools/ktr_ab.py --sweep [--kernels ...]                     # this tree

OTHER_TREE is another checkout of the repository (an unpacked `git
archive` of another commit). The A/B compiles fused_tr_batch.cu,
fused_gn_batch.cu, fused_lin.cu, ic_gn_batch.cu and ic_precompute.cu of
this tree and of OTHER_TREE, each alone into its own library with this
tree's nvcc flags, prints ptxas's register, stack and spill summary of
each (this tree's one-block and cluster instantiations apart; K-IC's and
K-ICpre's kernels one by one, with their shared memory), holds the
machine code (cuobjdump -sass) of each of OTHER_TREE's K-TR, K-GN and
K-LIN kernels against this tree's kernel of the same variant (K-TR's
and K-GN's one-block instantiation), instruction by instruction, binds each tree's C entry from the
`extern "C"` signature in its own source (a parameter the other tree
lacks, such as `cluster`, is left out of its call), and times each launch
of chip_smoke.cluster_workloads (K-TR, K-GN and K-GN-bi at B = 1 on a
480x640 level; K-TR and K-GN on 16 targets of a shared keyframe; the
ceres chain's five levels and the bench chain's three at 256 pairs) and
of chip_smoke.ic_workloads (K-ICpre and K-IC per level on 257 frames and
256 pairs, and at B = 1, at all five VGA levels) on the
same inputs in turns (other, this, this, other), by CUDA events over
repeated launches after a warm-up; K-LIN on chip_smoke.lin_workloads (one
linearization of 1, 16 and 256 pairs at every VGA level, both
samplings). For K-IC, K-ICpre and K-LIN it also holds this tree's
one-block launch (C = 1 forced, K-IC streamed; K-LIN G = 1) to
OTHER_TREE's outputs, bit for bit. The sweep launches this tree's kernels through
their C entries at 1, 2, 4, 8 and 16 blocks a pair (K-IC streamed and,
where the pack fits, resident; K-IC and K-ICpre at B = 1, 16, 128 (the
chunked chain's launches) and 256 at every VGA level), in turns (forward, then backward; the rule's layout
marked), with each layout's largest difference from one block a pair,
and times K-IC's serial tail (a 30x40 level's iteration against one of
256 pixels, one a thread); K-LIN at every split G from 1 to 512 blocks a
pair (while the last block still has pixels), at B = 1, 16 and 256 on
every VGA level, both samplings, each layout's
Gram against G = 1 (relative to its largest entry) and its valid counts:
this is how fused_batch.cluster_size's, ic_batch.ic_cluster_size's,
ic_batch.ic_resident's, ic.ic_precompute_cluster_size's and
fused_batch.lin_split's rules were chosen. Prints every time with
the card's name and power limit.
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
KINDS = ("tr", "gn", "lin", "ic", "icpre")
# K-LIN's split layouts the sweep times
LIN_SPLITS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512)


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
    """{mangled kernel name: (registers, stack bytes, spill bytes, static
    shared memory bytes)} from ptxas -v."""
    kernels = {}
    for chunk in stderr.split("Compiling entry function '")[1:]:
        name = chunk.split("'", 1)[0]
        regs = re.search(r"Used (\d+) registers", chunk)
        stack = re.search(r"(\d+) bytes stack frame", chunk)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", chunk)
        smem = re.search(r"(\d+) bytes smem", chunk)
        kernels[name] = (int(regs[1]) if regs else -1, int(stack[1]) if stack else 0,
                         int(spill[1]) + int(spill[2]) if spill else 0, int(smem[1]) if smem else 0)
    return kernels


def ptxas_summary(kernels: dict, clustered: bool) -> str:
    """Registers (range), the largest stack frame and spill stores plus
    loads over the kernels, and with a cluster layout (clustered) for its
    one-block and cluster instantiations apart."""
    def line(values):
        regs = [r for r, *_ in values]
        return (f"{len(regs)} kernels, {min(regs)}-{max(regs)} registers, stack <= "
                f"{max(v[1] for v in values)} B, spills <= {max(v[2] for v in values)} B")

    parts = [line(list(kernels.values()))]
    if clustered:
        for label, flag in (("one-block", "Lb0E"), ("cluster", "Lb1E")):
            parts.append(f"{label}: " + line([v for n, v in kernels.items() if template_args(n)[-1:] == (flag,)]))
    return "; ".join(parts)


def ptxas_each(kernels: dict) -> str:
    """Every kernel's template arguments, registers, static shared memory,
    stack and spills (K-IC: bilinear, cluster, resident; K-ICpre:
    cluster)."""
    return "; ".join(f"{''.join(template_args(n)) or n} {r} registers, {sm} B smem, stack {st} B, spills {sp} B"
                     for n, (r, st, sp, sm) in sorted(kernels.items()))


def ptxas_lin(kernels: dict) -> str:
    """K-LIN's registers, stack and spills: the linearization kernels (one
    a variant) and the gather pass."""
    groups = {}
    for name, value in kernels.items():
        groups.setdefault("linearization" if template_args(name) else "gather", {})[name] = value
    return "; ".join(f"{label}: {ptxas_summary(group, False)}" for label, group in sorted(groups.items()))


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
    from phovo_tpu_torch.ops.fused_batch import lin_split

    out = ROOT / "build" / "phovo_tpu_torch"
    out.mkdir(parents=True, exist_ok=True)
    trees = {"other": other, "this": ROOT}
    with ThreadPoolExecutor(2 * len(KINDS)) as pool:
        futures = {(key, kind): pool.submit(build, smoke, tree, kind, out / f"ktr_ab_{key}_{kind}.so")
                   for key, tree in trees.items() for kind in KINDS}
    entries = {k: f.result() for k, f in futures.items()}
    for (key, kind), (_, names, (kernels, _, clustered, seconds)) in entries.items():
        summary = (ptxas_each(kernels) if kind in ("ic", "icpre") else ptxas_lin(kernels) if kind == "lin"
                   else ptxas_summary(kernels, clustered))
        print(f"ptxas {key} tree {smoke.LEVEL_ENTRIES[kind][0]}: {summary}; C entry parameters {len(names)}; "
              f"nvcc {seconds:.1f} s")
    for kind in ("tr", "gn", "lin", "ic", "icpre"):
        compare_sass(entries["other", kind][2][:3], entries["this", kind][2][:3], smoke.LEVEL_ENTRIES[kind][0])
    rows = []
    for group, label, kind, args, kw in cases:
        runs = {key: smoke.entry_launcher(*entries[key, kind][:2], kind, args, kw) for key in trees}
        times = {key: [] for key in trees}
        for key in ("other", "this", "this", "other"):
            times[key].append(smoke.cuda_ms(runs[key][0], REPEATS))
        diff = float((runs["other"][1] - runs["this"][1]).abs().max())
        o, t = (sum(times[k]) / 2 for k in ("other", "this"))
        rows.append((group, o, t))
        if kind == "lin":
            one = smoke.entry_launcher(*entries["this", kind][:2], kind, args, kw, 1)
            one[0]()
            torch.cuda.synchronize()
            bits = torch.equal(one[1], runs["other"][1])
            scale = runs["other"][1].abs().amax(dim=(1, 2), keepdim=True)
            rel = float(((runs["this"][1] - runs["other"][1]).abs() / scale).max())
            same_nv = torch.equal(runs["this"][1][:, 7, 7], runs["other"][1][:, 7, 7])
            b = smoke.bound(*smoke.lin_case_work(args, kw, runs["this"][1]))
            note = (f"G = {lin_split(kw['H'], kw['W'])}, bound {b[0]:.5f} ms ({b[1]}), Gram max|diff| / "
                    f"largest entry {rel:.3e}, valid counts equal {same_nv}; G = 1 the other tree's bits {bits}")
        elif kind in ("ic", "icpre"):
            force = {"resident": False} if kind == "ic" else {}
            one = smoke.entry_launcher(*entries["this", kind][:2], kind, args, kw, 1, **force)
            one[0]()
            torch.cuda.synchronize()
            bits = all(torch.equal(a, b) for a, b in zip(one[1:], runs["other"][1:]))
            rule_bits = all(torch.equal(a, b) for a, b in zip(runs["this"][1:], runs["other"][1:]))
            H, W = (kw["H"], kw["W"]) if kind == "ic" else args[0].shape[1:]
            b = smoke.bound(*smoke.ic_case_work(kind, args, kw, *runs["this"][1:]))
            note = (f"rule {smoke.ic_layout(kind, H, W)}, bound {b[0]:.5f} ms ({b[1]}), max|diff| {diff:.3e}, the "
                    f"rule's outputs the same bits {rule_bits}; C = 1 streamed the other tree's bits {bits}")
        else:
            n_it = int((runs["other"][2][:, 0] != runs["this"][2][:, 0]).sum())
            note = f"max|state diff| {diff:.3e}, {n_it} pairs with other iteration counts"
        print(f"{group}, {label}: other tree {times['other'][0]:.4f}, {times['other'][1]:.4f} ms; this tree "
              f"{times['this'][0]:.4f}, {times['this'][1]:.4f} ms; this / other {t / o:.4f}; {note} [{card}]")
    print_totals(rows, ("other tree", "this tree"), card)


def sweep(smoke, cases, card: str) -> None:
    from phovo_tpu_torch.ops import _build
    from phovo_tpu_torch.ops import ic as IC
    from phovo_tpu_torch.ops import ic_batch as ICB
    from phovo_tpu_torch.ops.fused_batch import cluster_size

    lib = _build.library()
    totals = {}
    for group, label, kind, args, kw in cases:
        fn, names = getattr(lib, smoke.LEVEL_ENTRIES[kind][1]), smoke.entry_names(kind)
        H, W = (kw["H"], kw["W"]) if "H" in kw else args[0].shape[1:]
        # (blocks a pair, K-IC's resident flag or None) and the rule's layout
        layouts = [(c, r) for c in SWEEP
                   for r in ((False, True) if ICB.ic_pack_fits(H, W, c) else (False,)) if kind == "ic"]
        layouts = layouts or [(c, None) for c in SWEEP]
        rule = {"ic": (ICB.ic_cluster_size(H, W), ICB.ic_resident(H, W, ICB.ic_cluster_size(H, W))),
                "icpre": (IC.ic_precompute_cluster_size(H, W), None)}.get(kind, (cluster_size(H, W), None))
        runs = {}
        for c, r in layouts:
            run = smoke.entry_launcher(fn, names, kind, args, kw, c, **({} if r is None else {"resident": r}))
            try:
                run[0]()
            except RuntimeError as err:
                print(f"{group}, {label}: {c} blocks a pair{', resident' if r else ''} refused ({err})")
                continue
            runs[c, r] = run
        times = {key: [] for key in runs}
        for key in [*runs, *reversed(runs)]:
            times[key].append(smoke.cuda_ms(runs[key][0], REPEATS))
        base = runs[layouts[0]]
        parts = []
        for (c, r), (_, out, diag) in runs.items():
            diff = float((out - base[1]).abs().max())
            if kind == "icpre":
                extra = f"J8 the C = 1 bits {torch.equal(diag, base[2])}"
            else:
                extra = f"{int((diag[:, 0] != base[2][:, 0]).sum())} its differ"
                if r:
                    extra += f", streamed bits {all(torch.equal(a, b) for a, b in zip(runs[c, False][1:], (out, diag)))}"
            mark = " (rule)" if (c, r) == rule else ""
            name = f"C = {c}" + ("" if r is None else (" resident" if r else " streamed"))
            parts.append(f"{name}{mark} {sum(times[c, r]) / 2:.4f} ms (max|diff| {diff:.1e}, {extra})")
        for key in runs:
            name = f"C = {key[0]}" + ("" if key[1] is None else (" resident" if key[1] else " streamed"))
            acc = totals.setdefault(group, {}).setdefault(name, [0.0, 0])
            acc[0] += sum(times[key]) / 2
            acc[1] += 1
        print(f"{group}, {label}: " + "; ".join(parts) + f" [{card}]")
    for group, sums in totals.items():
        print(f"total {group}: " + ", ".join(f"{name} {t:.4f} ({n} levels)" for name, (t, n) in sums.items())
              + f" ms [{card}]")


def sweep_lin(smoke, cases, card: str) -> None:
    """K-LIN's layouts through its C entry on each case, in turns (forward,
    then backward): every split G of LIN_SPLITS while G / 2 blocks of
    kThreads do not already cover the level; each layout's Gram against
    G = 1's (relative to the largest entry), its valid counts and whether
    its bits are G = 1's."""
    from phovo_tpu_torch.ops import _build
    from phovo_tpu_torch.ops.fused_batch import lin_split

    fn, names = _build.library().phovo_fused_lin, smoke.entry_names("lin")
    totals = {}
    for group, label, kind, args, kw in cases:
        H, W = kw["H"], kw["W"]
        runs = {}
        for g in (g for g in LIN_SPLITS if g == 1 or (g // 2) * 256 < H * W):
            run = smoke.entry_launcher(fn, names, kind, args, kw, g)
            try:
                run[0]()
            except RuntimeError as err:
                print(f"{group}, {label}: split {g} refused ({err})")
                continue
            runs[g] = run
        times = {key: [] for key in runs}
        for key in [*runs, *reversed(runs)]:
            times[key].append(smoke.cuda_ms(runs[key][0], REPEATS))
        torch.cuda.synchronize()
        base = runs[1][1]
        scale = base.abs().amax(dim=(1, 2), keepdim=True)
        b = smoke.bound(*smoke.lin_case_work(args, kw, base))
        parts = []
        for g, (_, gram, _) in runs.items():
            rel = float(((gram - base).abs() / scale).max())
            nv = torch.equal(gram[:, 7, 7], base[:, 7, 7])
            name = f"G = {g}"
            mark = " (rule)" if g == lin_split(H, W) else ""
            ms = sum(times[g]) / 2
            parts.append(f"{name}{mark} {ms:.4f} ms (rel diff {rel:.1e}, nvalid equal {nv}"
                         f"{', G = 1 bits ' + str(torch.equal(gram, base)) if g > 1 else ''})")
            acc = totals.setdefault(group, {}).setdefault(name, [0.0, 0])
            acc[0] += ms
            acc[1] += 1
        print(f"{group}, {label}: " + "; ".join(parts) + f"; bound {b[0]:.5f} ms ({b[1]}) [{card}]")
    for group, sums in totals.items():
        print(f"total {group}: " + ", ".join(f"{name} {t:.4f} ({n} levels)" for name, (t, n) in sums.items())
              + f" ms [{card}]")


def serial_tail(smoke, prep, card: str) -> None:
    """K-IC's time an iteration at 30x40 against a level of 256 pixels (one
    a thread: the block_sum and the solve on one thread, with one pixel
    each), at B = 1 and 256, one block a pair, streamed and resident."""
    from phovo_tpu_torch.ops import _build
    from phovo_tpu_torch.ops.camera import TUM_FR1

    fn, names = _build.library().phovo_ic_gn_level_batch, smoke.entry_names("ic")
    for B in (1, 256):
        args, kw = smoke.ic_pair_args({4: tuple(x[:B + 1] for x in prep[4])}, 4, TUM_FR1)
        Ts, geom, J8, L, t_i, intr = args
        tiny = (Ts, geom[:, :, :256].contiguous(), J8[:, :, :256].contiguous(), L,
                t_i.reshape(B, -1)[:, :256].reshape(B, 1, 256).contiguous(), intr)
        for resident in (False, True):
            ms = {}
            for what, a, shape in (("30x40", args, kw), ("1x256", tiny, dict(H=1, W=256))):
                for n in (5, 50):
                    run = smoke.entry_launcher(fn, names, "ic", (*a, n, 0.0, 1.0), dict(shape, sampling="nearest"),
                                               1, resident=resident)
                    ms[what, n] = smoke.cuda_ms(run[0], REPEATS)
            per = {what: (ms[what, 50] - ms[what, 5]) / 45 for what in ("30x40", "1x256")}
            print(f"K-IC serial tail, B = {B}, one block a pair, {'resident' if resident else 'streamed'}: an "
                  f"iteration at 30x40 {1e3 * per['30x40']:.2f} us, at 1x256 (one pixel a thread) "
                  f"{1e3 * per['1x256']:.2f} us, {per['1x256'] / per['30x40']:.2f} of it; 50 iterations at 30x40 "
                  f"{ms['30x40', 50]:.4f} ms [{card}]")


def main() -> int:
    argv = sys.argv[1:]
    kinds = KINDS
    if len(argv) == 3 and argv[1] == "--kernels":
        kinds = tuple(argv[2].split(","))
        argv = argv[:1]
    if len(argv) != 1 or not set(kinds) <= set(KINDS) or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    from phovo_tpu_torch.ops import _build, se3

    smoke = chip_smoke()
    _build.library()
    dev = torch.device("cuda", 0)
    cases = []
    if "lin" in kinds:
        cases += smoke.lin_workloads(dev)
    if {"tr", "gn"} & set(kinds):
        frames, _ = smoke.keyframe_frames(se3)
        cases += [c for c in smoke.cluster_workloads(dev, frames[:smoke.KF_CHUNK + 1]) if c[2] in kinds]
    prep = None
    if {"ic", "icpre"} & set(kinds):
        Is, Ds = smoke.timing_frames(dev)
        prep, pre = smoke.ic_timing_prep(Is, Ds)
        del Is, Ds
        n_pairs = smoke.N_FRAMES - 1
        batches = (1, 16, n_pairs // 2, n_pairs) if argv[0] == "--sweep" else (n_pairs, 1)
        cases += [c for c in smoke.ic_workloads(prep, pre, batches) if c[2] in kinds]
    if argv[0] == "--sweep":
        sweep_lin(smoke, [c for c in cases if c[2] == "lin"], card)
        sweep(smoke, [c for c in cases if c[2] != "lin"], card)
        if "ic" in kinds:
            serial_tail(smoke, prep, card)
    else:
        ab(smoke, cases, Path(argv[0]).resolve(), card)
    return 0


if __name__ == "__main__":
    sys.exit(main())

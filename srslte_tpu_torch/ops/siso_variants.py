"""Source variants of the SISO kernel timed against the committed one, on one
NVIDIA GPU: ``python3 -m srslte_tpu_torch.ops.siso_variants`` from the
repository root (it takes its inputs and its timer from ``chip_smoke.py``).

A variant is ``csrc/tdec_siso.cu`` with a few text replacements, each of which
must match exactly once, and the shared bytes per block that its layout uses.
All variants are built at once, with ``_build``'s flags, into
``_build/variants/``.  At each path's shape (``chip_smoke.SISO_SHAPES``) and in
both numerics, every variant is first held to the plain version by value (max
abs difference 0, all four emit_ext / perm settings), then timed in `ROUNDS`
rounds, the order of the variants reversed every other round so that none
always runs first.  A round times 20 launches with `perm` and 20 without, by
CUDA events, as the turbo step launches the kernel (extrinsic out).  Printed
per variant and shape: the median over the rounds of the mean of the two, the
range over the rounds, the medians with and without `perm`, the resident
blocks per SM and the registers.  The last line is one JSON object of them.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys

import numpy as np
import torch

from . import _build, tdec_cuda

ROUNDS = 8
LAUNCHES = 20

# The fast path for chunks in which every window of the warp is live on both
# sides: no live mask and no carry-through pick.
FULL_CHUNK = [
    ("""    auto live_mask = [&](int t) {""",
     """    auto full_chunk = [&](int c) {
        bool ok = true;
#pragma unroll
        for (int h = 0; h < NW; ++h)
            ok = ok && lo[h] <= c && c + CHUNK <= hi[h] && lo[h] <= LT - c - CHUNK && LT - c <= hi[h];
        return __all_sync(FULL, ok) != 0;
    };
    auto live_mask = [&](int t) {"""),
    ("""    auto step = [&](int i, int k, auto llr) {
        constexpr bool LLR = decltype(llr)::value;""",
     """    auto step = [&](int i, int k, auto llr, auto... full) {
        constexpr bool LLR = decltype(llr)::value;
        constexpr bool FULL_ = sizeof...(full) > 0;"""),
    ("""        A = O::pick(live_mask(ta), na, A);
        Bm = O::pick(live_mask(tb), O::max(r0, r1), Bm);""",
     """        if (FULL_) {
            A = na;
            Bm = O::max(r0, r1);
        } else {
            A = O::pick(live_mask(ta), na, A);
            Bm = O::pick(live_mask(tb), O::max(r0, r1), Bm);
        }"""),
    ("""        } else {
#pragma unroll
            for (int k = 0; k < CHUNK; ++k) step(c + k, k, Hist());""",
     """        } else if (full_chunk(c)) {
#pragma unroll
            for (int k = 0; k < CHUNK; ++k) step(c + k, k, Hist(), 0);
        } else {
#pragma unroll
            for (int k = 0; k < CHUNK; ++k) step(c + k, k, Hist());"""),
    ("""        } else {
#pragma unroll
            for (int k = 0; k < CHUNK; ++k) step(c + k, k, Llr());""",
     """        } else if (full_chunk(c)) {
#pragma unroll
            for (int k = 0; k < CHUNK; ++k) step(c + k, k, Llr(), 0);
            finish(c, CHUNK);
        } else {
#pragma unroll
            for (int k = 0; k < CHUNK; ++k) step(c + k, k, Llr());"""),
]

# Every systematic value loaded from device memory on both sides (through
# `perm` where it is given), with no systematic buffer in shared memory.
NO_SYS_BUFFER = [
    ("auto gather_a = [&](int ta) { return ta < half; };",
     "auto gather_a = [&](int) { return true; };"),
    ("auto gather_b = [&](int tb) { return tb >= i0; };",
     "auto gather_b = [&](int) { return true; };"),
    ("        if (ta < i0) {  // a step before i0", "        if (false) {  // a step before i0"),
    ("reinterpret_cast<Pair<V>*>(sysb + (size_t)L * GROUPS)", "reinterpret_cast<Pair<V>*>(sysb)"),
    ("((size_t)L * LANES + L + 2 * CHUNK * 4)", "((size_t)L * LANES + 2 * CHUNK * 4)"),
]

# The committed kernel with its shared bytes padded to 75,776 per block, which
# leaves 3 blocks resident per SM instead of 6: how far the time follows the
# windows in flight.
HALF_RESIDENT = [
    ("return (size_t)GROUPS * word * ((size_t)L * LANES + L + 2 * CHUNK * 4);",
     "return 75776;"),
]


def _smem(L: int, sys_buffer: bool = True) -> int:
    return 4 * 4 * (8 * L + (L if sys_buffer else 0) + 64)


# name -> (replacements, shared bytes per block at window L)
VARIANTS = {
    "committed": ([], _smem),
    "full_chunk": (FULL_CHUNK, _smem),
    "no_sys_buffer": (NO_SYS_BUFFER, lambda L: _smem(L, False)),
    "half_resident": (HALF_RESIDENT, lambda L: 75776),
}


def variant_source(src: str, replacements) -> str:
    for old, new in replacements:
        if src.count(old) != 1:
            raise RuntimeError(f"variant text matches {src.count(old)} times: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def build_variants(variants, source: str = "tdec_siso") -> dict:
    """{name: (library, registers per kernel instance)} of the variants
    {name: (replacements, ...)} of csrc/<source>.cu, built in parallel."""
    import ctypes

    out_dir = _build.BUILD / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / f"{source}.cu").read_text()
    nvcc, procs = _build._nvcc(), {}
    for name, (reps, _) in variants.items():
        cu = out_dir / f"{source}_{name}.cu"
        cu.write_text(variant_source(src, reps))
        so = out_dir / f"lib{source}_{name}.so"
        procs[name] = (subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        regs = sorted({int(m) for m in re.findall(r"Used (\d+) registers", log)})
        libs[name] = (ctypes.CDLL(str(so)), regs)
    return libs


def main():
    import chip_smoke as cs
    from srslte_tpu_torch.phy.fec import turbo

    if not torch.cuda.is_available():
        raise SystemExit("siso_variants: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    libs = build_variants(VARIANTS)
    rng = np.random.default_rng(7)
    result = []
    for path, (B, K, L, T) in cs.SISO_SHAPES.items():
        pi = torch.as_tensor(turbo.qpp_perm(K).astype(np.int32), device="cuda")
        for bf16 in (False, True):
            if bf16:
                st = cs.bf16_siso_state(rng, B, K)
                a, p, b = st.sys_sat, st.par1, st.b01
            else:
                a, p, b = cs.turbo_siso_inputs(rng, B, K)
            plan = tdec_cuda.siso_plan(B, K, L, T, bf16)
            entry = "siso_windowed_bf16_launch" if bf16 else "siso_windowed_launch"
            runs = {}
            for name, (lib, _) in libs.items():
                fn, smem = tdec_cuda._entry(lib, entry), VARIANTS[name][1](L)
                runs[name] = (lambda ext, q, fn=fn, smem=smem: tdec_cuda._launch(
                    fn, a, p, b, L, T, ext, q, plan.blocks, smem))
            for ext, q in ((False, None), (True, None), (False, pi), (True, pi)):
                ref = tdec_cuda.siso_windowed_plain(a, p, b, L, T, ext, q).float()
                for name, run in runs.items():
                    err = float((run(ext, q).float() - ref).abs().max())
                    if err != 0.0:
                        raise RuntimeError(f"{name} {path} bf16={bf16} ext={ext} "
                                           f"perm={q is not None}: max abs diff {err}")
            times = {name: [] for name in runs}
            for r in range(ROUNDS):
                for name in (list(runs) if r % 2 == 0 else list(runs)[::-1]):
                    run = runs[name]
                    t_p = cs.event_ms(lambda: run(True, pi), LAUNCHES)
                    t_n = cs.event_ms(lambda: run(True, None), LAUNCHES)
                    times[name].append((t_p, t_n))
            base = float(np.median([sum(t) / 2 for t in times["committed"]]))
            for name, ts in times.items():
                means = [sum(t) / 2 for t in ts]
                smem = VARIANTS[name][1](L)
                row = {"variant": name, "path": path, "numerics": "bf16" if bf16 else "f32",
                       "shape": f"B={B} K={K} L={L} T={T}", "ms": float(np.median(means)),
                       "ms_min": min(means), "ms_max": max(means),
                       "ms_perm": float(np.median([t[0] for t in ts])),
                       "ms_no_perm": float(np.median([t[1] for t in ts])),
                       "smem_bytes": smem,
                       "blocks_per_sm": tdec_cuda.blocks_per_sm(plan._replace(smem_bytes=smem),
                                                                True, True, libs[name][0]),
                       "registers": libs[name][1]}
                row["x_committed"] = row["ms"] / base
                result.append(row)
                print(f"{path} {row['numerics']:4s} {name:14s} {row['ms']:.4f} ms "
                      f"[{row['ms_min']:.4f}, {row['ms_max']:.4f}] ({row['x_committed']:.3f} x "
                      f"committed; perm {row['ms_perm']:.4f}, no perm {row['ms_no_perm']:.4f}); "
                      f"{smem} shared bytes, {row['blocks_per_sm']} blocks per SM, registers "
                      f"{row['registers']}", flush=True)
            del a, p, b
    print(smi)
    print(json.dumps({"siso_variants": result}))


if __name__ == "__main__":
    sys.exit(main())

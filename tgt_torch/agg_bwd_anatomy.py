"""Where the time of the aggregate backward's bf16 body goes, on one CUDA card.

    python -m tgt_torch.agg_bwd_anatomy [--reps 20]

Builds ``tgt_torch/csrc/triplet_aggregate_bwd.cu`` as it is and in variants
with one part of the body's loop removed or replaced (each a patched copy of
the source, compiled with the package's ``nvcc`` flags under the git-ignored
build directory), and times each back to back at N=48, edge width 256, 16
triplet heads, bf16, b=16 and b=32, for blocks of 8 and of 16 heads:

- ``full``: the body;
- ``loads only``: the copies, their waits and the barriers, with no
  transposes, products or dV pieces;
- ``no transposes``, ``no products``, ``no dV pieces``: one part removed;
- ``cp.async loads``: blocks of 16 heads read dva by cp.async, 16 bytes a
  thread, in place of the bulk copy.

A copy instrumented with ``clock64`` gives, per j and warp, the cycles of
the loop's work (products, transposes, dV's pieces and stores), of the wait
for the next stage, of the barrier and of issuing the next copies.

Prints one JSON line per variant and one per instrumented run, each with the
card's name and power limit. The removed parts make the outputs wrong; only
``full`` is held against the plain version (1e-2 of max|ref|).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess

import torch

from tgt_torch.ops.kernels import _build
from tgt_torch.ops.kernels import triplet_aggregate as ta

SOURCE = _build.CSRC_DIR / "triplet_aggregate_bwd.cu"
OUT_DIR = _build.BUILD_DIR / "anatomy"

TRANSPOSES = (
    "    to_panels<DP, OCT, HB>(st, dva_panels(j) + g * kGroup * HSD, HSD, n * OCT, u, lane);\n",
    "    to_panels<DP, OCT, HB>(st + NP * D * HB, v_panels(j) + g * kGroup * HSV, HSV, krows * OCT,\n"
    "                           u, lane);\n")
PRODUCTS = (
    "        mma(acc[mt][0], af, vb[0], vb[1]);\n",
    "        mma(acc[mt][1], af, vb[2], vb[3]);\n",
    "        mma(o[2 * e], at[mt], bt[0], bt[1]);\n",
    "        if (2 * e + 1 < OCT) mma(o[2 * e + 1], at[mt], bt[2], bt[3]);   // past d: padding\n")
PIECES = (
    "    to_pieces<PS, OCT, HB>(o_p + (j & 1) * L::OPANEL + g * kGroup * HSO, HSO,\n"
    "                           out + (j & 1) * L::OUT + g * kGroup, krows * OCT, u, lane);\n",)
# blocks of 16 heads: dva by cp.async (piece q is (row, d, group)), no barrier
CP_ASYNC = (
    ("      if constexpr (HB == 16) {\n        if (threadIdx.x == 0) {",
     "      if constexpr (false) {\n        if (threadIdx.x == 0) {"),
    ("          cp_async16(st + q * kGroup, src + (long long)q * h);",
     "          cp_async16(st + q * kGroup, src + (long long)(q / G) * h + (q % G) * kGroup);"),
    ("    if constexpr (HB == 16) {\n      if (j < n) mbar_wait",
     "    if constexpr (false) {\n      if (j < n) mbar_wait"))
# clock64 around the loop's work, wait, barrier and copies
CLOCKS = (
    ("namespace tagb {\n", "namespace tagb {\n__device__ unsigned long long g_cycles[5];\n"),
    ("  for (int j = 0; j < n; ++j) {\n    if (!products_first) {",
     "  long long cyc[4] = {0, 0, 0, 0};\n"
     "  for (int j = 0; j < n; ++j) {\n    const long long t0 = clock64();\n"
     "    if (!products_first) {"),
    ("    arrived(j + 2, S - 2);\n    __syncthreads();\n    fetch(j + 1 + S);\n  }",
     "    const long long t1 = clock64();\n    arrived(j + 2, S - 2);\n"
     "    const long long t2 = clock64();\n    __syncthreads();\n"
     "    const long long t3 = clock64();\n    fetch(j + 1 + S);\n"
     "    const long long t4 = clock64();\n"
     "    cyc[0] += t1 - t0; cyc[1] += t2 - t1; cyc[2] += t3 - t2; cyc[3] += t4 - t3;\n  }\n"
     "  if (lane == 0) {\n"
     "    for (int x = 0; x < 4; ++x) atomicAdd(&g_cycles[x], (unsigned long long)cyc[x]);\n"
     "    atomicAdd(&g_cycles[4], (unsigned long long)n);\n  }"),
    ("extern \"C\" int triplet_aggregate_bwd_body(",
     "extern \"C\" int read_cycles(unsigned long long* out) {\n"
     "  unsigned long long zero[5] = {0, 0, 0, 0, 0};\n"
     "  int e = (int)cudaMemcpyFromSymbol(out, tagb::g_cycles, sizeof(zero));\n"
     "  cudaMemcpyToSymbol(tagb::g_cycles, zero, sizeof(zero));\n  return e;\n}\n\n"
     "extern \"C\" int triplet_aggregate_bwd_body("))

VARIANTS = {
    "full": (),
    "loads only": tuple((x, "") for x in TRANSPOSES + PRODUCTS + PIECES),
    "no transposes": tuple((x, "") for x in TRANSPOSES),
    "no products": tuple((x, "") for x in PRODUCTS),
    "no dV pieces": tuple((x, "") for x in PIECES),
    "cp.async loads": CP_ASYNC,
    "clocks": CLOCKS,
}


def patched(source: str, edits) -> str:
    for old, new in edits:
        if source.count(old) != 1:
            raise RuntimeError(f"the body's source changed; this tool no longer "
                               f"finds {old!r}")
        source = source.replace(old, new)
    return source


def build(names):
    """{variant: ctypes library}, one nvcc per variant, all started together."""
    if OUT_DIR.exists():
        shutil.rmtree(OUT_DIR)
    OUT_DIR.mkdir(parents=True)
    for header in _build.CSRC_DIR.glob("*.cuh"):
        shutil.copy(header, OUT_DIR)
    source = SOURCE.read_text()
    procs = {}
    for i, name in enumerate(names):
        src = OUT_DIR / f"variant{i}.cu"
        src.write_text(patched(source, VARIANTS[name]))
        procs[name] = (subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
             str(OUT_DIR / f"libvariant{i}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), i)
    libs = {}
    for name, (proc, i) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(OUT_DIR / f"libvariant{i}.so"))
    return libs


def device_ms(fn, reps: int) -> float:
    """Device time of one call when calls run back to back: a spin kernel
    holds the card while the host queues ``reps`` calls behind it."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("agg_bwd_anatomy: no CUDA device is available")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]
    libs = build(list(VARIANTS))
    gen = torch.Generator(device="cuda").manual_seed(3)
    for b in (16, 32):
        a = torch.softmax(torch.randn(b, 48, 48, 16, device="cuda", generator=gen),
                          dim=2).to(torch.bfloat16)
        v, dva = (torch.randn(b, 48, 48, 16, 16, device="cuda", generator=gen)
                  .to(torch.bfloat16) for _ in range(2))
        ref = ta.triplet_aggregate_bwd_reference(a, v, dva)
        da, dv = torch.empty_like(a), torch.empty_like(v)
        strides = _build.strides(v.stride()[:3])
        for heads in (8, 16):
            row = {"anatomy": "triplet_aggregate_bwd body", "b": b, "n": 48,
                   "heads_per_block": heads, "card": card}
            for name, lib in libs.items():
                entry = ta.BWD_BODY.bind(lib)

                def call():
                    _build.launch(entry, v, a.data_ptr(), v.data_ptr(),
                                  dva.data_ptr(), da.data_ptr(), dv.data_ptr(),
                                  b, 48, 16, 16, heads, strides)

                call()
                torch.cuda.synchronize()
                if name == "full":
                    err = max(float((x.float() - r.float()).abs().max())
                              / float(r.float().abs().max())
                              for x, r in zip((da, dv), ref))
                    if err > 1e-2:
                        raise RuntimeError(f"the body disagrees: {err}")
                if name == "clocks":
                    buf = (ctypes.c_ulonglong * 5)()
                    lib.read_cycles(buf)            # resets the counts
                    call()
                    torch.cuda.synchronize()
                    lib.read_cycles(buf)
                    warp_js = buf[4]                # sum over warps of n
                    row["cycles_per_j_and_warp"] = {
                        part: buf[x] / warp_js for x, part in enumerate(
                            ("work", "wait", "barrier", "copies"))}
                else:
                    row[name] = device_ms(call, args.reps)
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Launch-shape sweep of the row-merge probe's kernels on the card:

    python -m mla_tpu_torch.ops.row_merge_sweep

Builds ``csrc/row_merge.cu`` once more, into a library of its own, beside
sweep entry points that launch ``scale2`` at several (threads per block,
float4s per thread, grid cap, cache hint) settings and ``row_merge_bulk`` at
several (ring stages, stage bytes, units per block) settings. At each probe
shape it holds every setting bit-exact against the plain version and times
it (CUDA events, L2-cold inputs), beside ``row_merge_generic``, the library
calls, and a probe of one bulk block's phases. The settings the port
launches are constants in the source; this script only informs their
choice. Prints one line per timing and, last, one JSON record.
"""

from __future__ import annotations

import ctypes
import hashlib
import itertools
import json
import subprocess
import sys
from pathlib import Path

import torch

from mla_tpu_torch.ops import _build
from mla_tpu_torch.ops import row_merge as rm
from mla_tpu_torch.utils.cuda_timing import device_median_ms, l2_cold

# (threads per block, float4s per thread, waves of resident blocks (0: no
# cap), evict-first hints)
SCALE2_CONFIGS = tuple(itertools.product((128, 256, 512), (1, 2, 4), (1, 0), (1, 0)))
# (ring stages, stage bytes, units per block (0: the launcher's rule))
BULK_CONFIGS = ((4, 16384, 0), (4, 16384, 1), (4, 16384, 2), (4, 16384, 4), (4, 16384, 8),
                (4, 16384, 12), (6, 16384, 6), (6, 16384, 12), (8, 16384, 8), (8, 16384, 16),
                (4, 8192, 8), (4, 8192, 16), (8, 8192, 16), (4, 32768, 4), (4, 32768, 8))
SHAPES = (((960, 160), 3), ((4096, 1024), 4), ((16384, 4096), 4))
PEAK_BYTES = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet


# Where the bulk kernel's time goes when one block copies one output row of
# `rows` source rows (x, out 16-byte aligned, C * 4 % 16 == 0): phase 0 sets
# up the barrier and exits, 1 also loads the row into shared memory, 2 also
# stores it (the whole unit).
_PHASES_SOURCE = r"""
__global__ void __launch_bounds__(32)
bulk_phases(const char* x, char* out, int64_t cb, int64_t rows, int phase) {
  extern __shared__ __align__(128) char ring[];
  __shared__ __align__(8) uint64_t bar;
  const int64_t rb = rows * cb, row0 = static_cast<int64_t>(blockIdx.x) * rb;
  if (threadIdx.x != 0) return;
  const uint32_t b = smem_u32(&bar), dst = smem_u32(ring);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(b) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  if (phase == 0) return;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b),
               "r"(static_cast<uint32_t>(rb)) : "memory");
  for (int64_t j = 0; j < rows; ++j)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
        "[%3];\n" ::"r"(dst + static_cast<uint32_t>(j * cb)),
        "l"(reinterpret_cast<uint64_t>(x + row0 + j * cb)), "r"(static_cast<uint32_t>(cb)),
        "r"(b) : "memory");
  mbar_wait(b, 0);
  if (phase == 1) return;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
                   reinterpret_cast<uint64_t>(out + row0)), "r"(dst),
               "r"(static_cast<uint32_t>(rb)) : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
extern "C" int mla_bulk_phases(const float* x, float* out, int64_t r, int64_t c, int64_t rows,
                               int64_t phase, int64_t smem, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(bulk_phases, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  bulk_phases<<<static_cast<int>(r / rows), 32, smem, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const char*>(x), reinterpret_cast<char*>(out), 4 * c, rows,
      static_cast<int>(phase));
  return static_cast<int>(cudaGetLastError());
}
"""
PHASES = ((0, 65536), (1, 65536), (2, 65536), (2, 4096))


def _sweep_source() -> str:
    s2 = "\n".join(
        f"    case {t * 100 + v}{h}: return launch_scale2<{t}, {v}, {'true' if h else 'false'}>"
        f"(x, out, n, waves, s);"
        for t, v, h in sorted({(t, v, h) for t, v, _, h in SCALE2_CONFIGS}))
    bulk = "\n".join(f"    case {k}: return launch_row_merge_bulk<{k}>(x, out, r, c, rows, "
                     f"static_cast<int>(stage), per_block, s);"
                     for k in sorted({k for k, _, _ in BULK_CONFIGS}))
    return f"""#include "row_merge.cu"
extern "C" int mla_scale2_sweep(const float* x, float* out, int64_t n, int64_t threads,
                                int64_t vecs, int64_t stream_hint, int64_t waves,
                                void* stream) {{
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((threads * 100 + vecs) * 10 + stream_hint) {{
{s2}
  }}
  return static_cast<int>(cudaErrorInvalidValue);
}}
extern "C" int mla_row_merge_bulk_sweep(const float* x, float* out, int64_t r, int64_t c,
                                        int64_t rows, int64_t stages, int64_t stage,
                                        int64_t per_block, void* stream) {{
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (stages) {{
{bulk}
  }}
  return static_cast<int>(cudaErrorInvalidValue);
}}
{_PHASES_SOURCE}"""


def _load_sweep() -> ctypes.CDLL:
    text = _sweep_source()
    digest = hashlib.sha256(text.encode() + (_build.CSRC / "row_merge.cu").read_bytes())
    src = _build.BUILD_DIR / "row_merge_sweep.cu"
    lib = _build.BUILD_DIR / f"librow_merge_sweep_{digest.hexdigest()[:16]}.so"
    if not lib.exists():
        src.parent.mkdir(parents=True, exist_ok=True)
        src.write_text(text)
        _build.compile_library(src, lib, ("-I", str(_build.CSRC)))
    dll = ctypes.CDLL(str(lib))
    p, i = ctypes.c_void_p, ctypes.c_int64
    dll.mla_scale2_sweep.argtypes = [p, p, i, i, i, i, i, p]
    dll.mla_row_merge_bulk_sweep.argtypes = [p, p, i, i, i, i, i, i, p]
    dll.mla_bulk_phases.argtypes = [p, p, i, i, i, i, i, p]
    dll.mla_scale2_sweep.restype = dll.mla_row_merge_bulk_sweep.restype = ctypes.c_int
    dll.mla_bulk_phases.restype = ctypes.c_int
    return dll


def _call(fn, *args):
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__}{args[2:]} failed: cudaError {err}")


def main() -> int:
    if not torch.cuda.is_available():
        print("row_merge_sweep needs an NVIDIA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {card}")
    lib = _load_sweep()
    print(Path(lib._name).with_suffix(".log").read_text())  # ptxas: registers, spills
    gen = torch.Generator().manual_seed(0)
    record = {"card": card, "us": {}}
    for shape, rows in SHAPES:
        x = torch.randn(shape, generator=gen).cuda()
        nxt, n_copies = l2_cold(x)
        merged = (shape[0] // rows, rows * shape[1])
        bound_us = rm.bytes_moved(x) / PEAK_BYTES * 1e6

        def scale2_at(t, v, w, h):
            def run():
                xi = nxt()
                out = torch.empty_like(xi)
                _call(lib.mla_scale2_sweep, xi.data_ptr(), out.data_ptr(), xi.numel(), t, v, h,
                      w)
                return out
            return run

        def bulk_at(k, stage, per_block):
            def run():
                xi = nxt()
                out = torch.empty(merged, device=xi.device)
                _call(lib.mla_row_merge_bulk_sweep, xi.data_ptr(), out.data_ptr(), *shape, rows,
                      k, stage, per_block)
                return out
            return run

        def generic():
            xi = nxt()
            out = torch.empty(merged, device=xi.device)
            rm._launch("mla_row_merge_generic", xi, out, *shape, rows)
            return out

        cases = {f"scale2 {t}x{v} waves {w} {'cs' if h else 'plain'}": (scale2_at(t, v, w, h),
                                                                           "scale2")
                 for t, v, w, h in SCALE2_CONFIGS}
        cases.update({f"row_merge_bulk {k}x{s // 1024}KB units/block {b or 'rule'}": (
            bulk_at(k, s, b), "row_merge") for k, s, b in BULK_CONFIGS})
        cases["row_merge_generic"] = (generic, "row_merge")
        cases["library torch.mul(x, 2)"] = (lambda: torch.mul(nxt(), 2), "scale2")
        cases["library reshape().clone()"] = (lambda: nxt().reshape(merged).clone(), "row_merge")
        def phase_at(ph, smem):
            def run():
                xi = nxt()
                out = torch.empty(merged, device=xi.device)
                _call(lib.mla_bulk_phases, xi.data_ptr(), out.data_ptr(), *shape, rows, ph, smem)
                return out
            return run

        key = f"{list(shape)} rows {rows}"
        record["us"][key] = {"bound_us": bound_us, "input_copies": n_copies}
        for ph, smem in PHASES:
            if ph in (1, 2) and smem < 4 * rows * shape[1]:
                continue  # one output row must fit the stage
            us = device_median_ms(phase_at(ph, smem), inner=20) * 1e3
            record["us"][key][f"bulk phase {ph} smem {smem}"] = us
            print(f"sweep {key}: bulk phase {ph}, {smem} B dynamic shared memory, one "
                  f"block per output row: {us:.3f} us ({card})")
        wants = {"scale2": rm.scale2_reference(x), "row_merge": rm.row_merge_reference(x, rows)}
        for label, (fn, kind) in cases.items():
            want = wants[kind]
            got = fn()  # every copy holds x, so any call's output must equal want
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise RuntimeError(f"{label} at {key} is not bit-exact")
            us = device_median_ms(fn, inner=20) * 1e3
            record["us"][key][label] = us
            print(f"sweep {key}: {label}: {us:.3f} us, {bound_us / us:.4f} of bound "
                  f"({bound_us:.3f} us) ({card})")
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Phase probe of the tensor-core front-end kernel on the card:

    python -m mla_tpu_torch.ops.fused_frontend_phases

Builds ``csrc/fused_frontend.cu`` once more, into a library of its own,
beside an entry point that launches ``fused_log_mel_mma_kernel`` with only
some of its phases (staging the frames, the DFT on the tensor cores, the
mel product and log). It times each mask at the serving shape [8, 77120]
and the training shape [64, 64000], per precision mode, at the frame tile
the wrapper picks, beside the whole kernel through the wrapper (CUDA
events). The port always launches every phase; this script only shows where
a block's time goes. A block's phases run one after another, so the masks'
times are read as differences along the order stage, stage + DFT, all.
Prints one line per timing and, last, one JSON record.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import subprocess
import sys

import torch

from mla_tpu_torch.config import FrontendConfig
from mla_tpu_torch.ops import _build
from mla_tpu_torch.ops import fused_frontend as ff
from mla_tpu_torch.utils.cuda_timing import device_median_ms

# (name, mask): kStage 1, kDft 2, kMel 4 in csrc/fused_frontend.cu
MASKS = (("stage", 1), ("dft", 2), ("mel", 4), ("stage+dft", 3), ("all", 7))
SHAPES = (("serving", (8, 77120)), ("training", (64, 64000)))

_PROBE_SOURCE = r"""
template <int MODE, int MF>
cudaError_t launch_phases(int phases, const float* wav, const void* basis, const float* mel_w,
                          float* out, int batch, int n_samples, int used_frames, int window,
                          int kp, int hop, int np_, int n_mel, float log_offset,
                          cudaStream_t s) {
#define MLA_PHASES(P)                                                                     \
  case P:                                                                                 \
    return launch_mma<MODE, MF, P>(wav, basis, mel_w, out, batch, n_samples, used_frames, \
                                   window, kp, hop, np_, n_mel, log_offset, s);
  switch (phases) {
    MLA_PHASES(1) MLA_PHASES(2) MLA_PHASES(3) MLA_PHASES(4) MLA_PHASES(7)
    default:
      return cudaErrorInvalidValue;
  }
#undef MLA_PHASES
}

template <int MODE>
cudaError_t launch_phases_bm(int bm, int phases, const float* wav, const void* basis,
                             const float* mel_w, float* out, int batch, int n_samples,
                             int used_frames, int window, int kp, int hop, int np_, int n_mel,
                             float log_offset, cudaStream_t s) {
  switch (bm) {
    case 16:
      return launch_phases<MODE, 1>(phases, wav, basis, mel_w, out, batch, n_samples,
                                    used_frames, window, kp, hop, np_, n_mel, log_offset, s);
    case 32:
      return launch_phases<MODE, 2>(phases, wav, basis, mel_w, out, batch, n_samples,
                                    used_frames, window, kp, hop, np_, n_mel, log_offset, s);
    case 64:
      return launch_phases<MODE, 4>(phases, wav, basis, mel_w, out, batch, n_samples,
                                    used_frames, window, kp, hop, np_, n_mel, log_offset, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" int mla_fused_log_mel_phases(const float* wav, const void* basis,
                                        const float* mel_w, float* out, int batch,
                                        int n_samples, int used_frames, int window, int kp,
                                        int hop, int np_, int n_mel, float log_offset,
                                        int mode, int bm, int phases, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kF32:
      return launch_phases_bm<kF32>(bm, phases, wav, basis, mel_w, out, batch, n_samples,
                                    used_frames, window, kp, hop, np_, n_mel, log_offset, s);
    case kBf16:
      return launch_phases_bm<kBf16>(bm, phases, wav, basis, mel_w, out, batch, n_samples,
                                     used_frames, window, kp, hop, np_, n_mel, log_offset, s);
    case kBf16x3:
      return launch_phases_bm<kBf16x3>(bm, phases, wav, basis, mel_w, out, batch, n_samples,
                                       used_frames, window, kp, hop, np_, n_mel, log_offset,
                                       s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
"""

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _load() -> ctypes.CDLL:
    """The kernel source with the probe's entry point, built into
    build/mla_tpu_torch/ under a name that hashes both."""
    combined = (_build.CSRC / "fused_frontend.cu").read_text() + _PROBE_SOURCE
    digest = hashlib.sha256(combined.encode()).hexdigest()[:16]
    src = _build.BUILD_DIR / "fused_frontend_phases.cu"
    lib_path = _build.BUILD_DIR / f"libfused_frontend_phases_{digest}.so"
    if not lib_path.exists():
        src.parent.mkdir(parents=True, exist_ok=True)
        src.write_text(combined)
        _build.compile_library(src, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    lib.mla_fused_log_mel_phases.argtypes = [_P] * 4 + [_I] * 8 + [_F, _I, _I, _I, _P]
    lib.mla_fused_log_mel_phases.restype = ctypes.c_int
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("fused_frontend_phases: needs an NVIDIA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    tag = f"({card})"
    lib = _load()
    cfg = FrontendConfig()
    kp, np_ = ff.padded_sizes(cfg)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator().manual_seed(0)
    record = {"card": card, "ms": {}}
    for site, shape in SHAPES:
        wav = (torch.randn(shape, generator=gen) * 0.1).cuda()
        b, n = shape
        _, hop, used, _, _, _ = ff._framing_plan(cfg, n)
        out = torch.empty((b, used, cfg.num_mel_bins), device=wav.device)
        stream = torch.cuda.current_stream().cuda_stream
        for precision in ("default", "bf16x3", "highest"):
            basis, mel = ff._mma_operands(cfg, wav.device, precision)
            bm = ff.tile_frames(b, used, kp, np_, precision, n_sm)

            def run(mask, basis=basis, mel=mel, bm=bm, precision=precision):
                err = lib.mla_fused_log_mel_phases(
                    wav.data_ptr(), basis.data_ptr(), mel.data_ptr(), out.data_ptr(), b, n,
                    used, cfg.window_length, kp, hop, np_, cfg.num_mel_bins, cfg.log_offset,
                    ff._MODES[precision], bm, mask, stream)
                if err != 0:
                    raise RuntimeError(f"phase probe launch failed: cudaError {err}")

            times = {name: device_median_ms(lambda m=mask: run(m)) for name, mask in MASKS}
            times["wrapper"] = device_median_ms(
                lambda p=precision: ff.fused_log_mel_patches(wav, cfg, p))
            key = f"{site} {list(shape)} {precision} BM {bm}"
            record["ms"][key] = times
            print(f"phases: {key}: " + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items())
                  + f" {tag}")
    print(card)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())

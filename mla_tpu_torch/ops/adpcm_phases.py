"""Phase probe of the ADPCM scan kernel on the card:

    python -m mla_tpu_torch.ops.adpcm_phases

Builds ``csrc/adpcm.cu`` once more, into a library of its own, beside an
entry point that launches ``adpcm_decode_scan`` with a phase mask (the
kernel's ``Phase``): all phases; without the two segment scans ("no_scan":
the lanes walk from their own start state, so the output is wrong and only
the time means anything); without the stores ("no_store": a guarded store
that never fires keeps the work alive); and with clock stamps in thread
block 0 ("stamps"). It times the first three at the serving site
[8, 77120] block 64 and the training site [64, 64000] block 256, per width,
on L2-cold wires (CUDA events, bursts behind a spin kernel), beside both
variants through the wrapper, L2-cold and on a wire left in the L2 cache;
the full mask is held bit-exact first. The
stamps give block 0's cycles from entry to its barrier and, per step,
waiting for the staged wire and reading codes and header, issuing the next
copy, decoding with its stores, and from one step to the next. The port
launches only the full mask; this script shows where its time goes. Prints
one line per timing and, last, one JSON record.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import subprocess
import sys

import numpy as np
import torch

from mla_tpu_torch.data import adpcm
from mla_tpu_torch.data.audio_io import pcm16_quantize
from mla_tpu_torch.ops import _build
from mla_tpu_torch.ops import adpcm as ad
from mla_tpu_torch.utils.cuda_timing import device_median_ms, l2_cold

SITES = (("serving", (8, 77120), 64), ("training", (64, 64000), 256))
# (name, mask): kScans 1, kStores 2, kAllPhases 3, kStamps 4 in csrc/adpcm.cu
MASKS = (("full", 3), ("no_scan", 2), ("no_store", 1))
STAMPS = 3 | 4
WARPS, STEPS = 8, 4  # kScanWarps and kStampSteps in csrc/adpcm.cu

_PROBE_SOURCE = r"""
extern "C" int mla_adpcm_decode_scan_phases(const uint8_t* wire, float* out, int64_t units,
                                            int nb, int block, int n, int bits, int phases,
                                            void* stream) {
  switch (phases) {
    case kScans:
      return decode_scan<kScans>(wire, out, units, nb, block, n, bits, stream);
    case kStores:
      return decode_scan<kStores>(wire, out, units, nb, block, n, bits, stream);
    case kAllPhases:
      return decode_scan<kAllPhases>(wire, out, units, nb, block, n, bits, stream);
    case kAllPhases | kStamps:
      return decode_scan<kAllPhases | kStamps>(wire, out, units, nb, block, n, bits, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// zero: clear the stamps; else copy them to host
extern "C" int mla_adpcm_stamps(unsigned long long* host, int zero) {
  static unsigned long long z[sizeof(g_stamps) / sizeof(unsigned long long)];
  return static_cast<int>(zero ? cudaMemcpyToSymbol(g_stamps, z, sizeof(g_stamps))
                               : cudaMemcpyFromSymbol(host, g_stamps, sizeof(g_stamps)));
}
"""

_P, _L, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int


def _load() -> ctypes.CDLL:
    """The kernel source with the probe's entry points, built into
    build/mla_tpu_torch/ under a name that hashes both."""
    combined = (_build.CSRC / "adpcm.cu").read_text() + _PROBE_SOURCE
    digest = hashlib.sha256(combined.encode()).hexdigest()[:16]
    src = _build.BUILD_DIR / "adpcm_phases.cu"
    lib_path = _build.BUILD_DIR / f"libadpcm_phases_{digest}.so"
    if not lib_path.exists():
        src.parent.mkdir(parents=True, exist_ok=True)
        src.write_text(combined)
        _build.compile_library(src, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    lib.mla_adpcm_decode_scan_phases.argtypes = [_P, _P, _L, _I, _I, _I, _I, _I, _P]
    lib.mla_adpcm_stamps.argtypes = [_P, _I]
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("adpcm_phases: needs an NVIDIA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    tag = f"({card})"
    lib = _load()
    rng = np.random.default_rng(0)
    record = {"card": card, "us": {}, "stamps_cycles": {}}
    stream = torch.cuda.current_stream().cuda_stream
    for bits, enc in ((4, adpcm.adpcm4_encode), (2, adpcm.adpcm2_encode)):
        for site, shape, block in SITES:
            wire = torch.from_numpy(enc(pcm16_quantize(0.3 * rng.standard_normal(shape)),
                                        block=block)).cuda()
            rows, n = shape
            nb = -(-n // block)
            out = torch.empty(shape, device="cuda")
            nxt, _ = l2_cold(wire)

            def launch(mask, w):
                err = lib.mla_adpcm_decode_scan_phases(w.data_ptr(), out.data_ptr(), rows * nb,
                                                       nb, block, n, bits, mask, stream)
                if err != 0:
                    raise RuntimeError(f"adpcm_phases launch failed: cudaError {err}")

            launch(3, wire)
            torch.cuda.synchronize()
            if not torch.equal(out, ad.adpcm_decode_reference(wire, n, block, bits)):
                raise RuntimeError("adpcm_phases: the full mask is not bit-exact")
            us = {name: device_median_ms(lambda m=mask: launch(m, nxt()), inner=20) * 1e3
                  for name, mask in MASKS}
            for variant in ad.LAUNCHES_BY_VARIANT:
                us[f"{variant} (wrapper)"] = device_median_ms(lambda v=variant: ad.adpcm_decode(
                    nxt(), n, block, bits, _variant=v), inner=20) * 1e3
                # one wire for every launch: it stays in the L2 cache, as a wire
                # just uploaded (the server's) or just gathered (training's) is
                us[f"{variant} (wrapper, L2-warm)"] = device_median_ms(
                    lambda v=variant: ad.adpcm_decode(wire, n, block, bits, _variant=v),
                    inner=20) * 1e3
            key = f"{bits}-bit {site} {list(shape)} block {block}"
            record["us"][key] = us
            print(f"phases (us): {key}: " + ", ".join(f"{k} {v:.3f}" for k, v in us.items())
                  + f" {tag}")

            stamps = np.zeros((WARPS, 2 + 4 * STEPS), np.uint64)
            lib.mla_adpcm_stamps(None, 1)
            launch(STAMPS, wire)
            torch.cuda.synchronize()
            lib.mla_adpcm_stamps(stamps.ctypes.data_as(ctypes.c_void_p), 0)
            c = stamps.astype(np.int64)
            steps = [s for s in range(STEPS) if (c[:, 5 + 4 * s] > 0).all()]
            phase = {"entry to barrier": float(np.mean(c[:, 1] - c[:, 0]))}
            for name, a, b in (("wait, codes and header", 0, 1), ("issue the next copy", 1, 2),
                               ("decode and stores", 2, 3)):
                phase[name] = float(np.mean([c[:, 2 + 4 * s + b] - c[:, 2 + 4 * s + a]
                                             for s in steps]))
            phase["between steps"] = float(np.mean([c[:, 2 + 4 * s] - c[:, 5 + 4 * (s - 1)]
                                                    for s in steps if s > 0] or [0]))
            phase["steps stamped"] = len(steps)
            record["stamps_cycles"][key] = phase
            print(f"stamps (cycles, block 0, mean over its warps and steps): {key}: "
                  + ", ".join(f"{k} {v:.0f}" for k, v in phase.items()) + f" {tag}")
            del nxt
    print(card)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())

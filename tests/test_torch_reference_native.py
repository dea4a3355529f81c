"""The JAX package's native libraries as the port's tests get them
(``tests/torch_port_common.py::reference_native``): whatever a lost build
race left in the process (a cached failed load, a half-written library in
the reference's ``_SRC_DIR``), the reference's own loaders load a private
build of the unedited source made with the reference's own g++ argv; a
failed build raises with g++'s output; concurrent builders build once and
never expose a partial file."""

import sys

sys.modules["conftest"].QUICK_MODULES.add(__name__.rsplit(".", 1)[-1])

import ctypes  # noqa: E402
import inspect  # noqa: E402
import io  # noqa: E402
import re  # noqa: E402
import threading  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
from scipy.io import wavfile  # noqa: E402

from tests import torch_port_common as common  # noqa: E402

MODULES = common.REFERENCE_NATIVE_MODULES


def test_argv_is_the_reference_s_own():
    """REFERENCE_GXX is, token for token, the argv in both reference loaders."""
    for module in MODULES.values():
        tokens = re.findall(r'"([^"]*)"', inspect.getsource(module._build_and_load))
        at = tokens.index("g++")
        assert tuple(tokens[at: at + len(common.REFERENCE_GXX)]) == common.REFERENCE_GXX


@pytest.mark.parametrize("name", sorted(MODULES))
def test_lost_race_still_gives_the_reference_library(name, tmp_path, monkeypatch):
    """A process that lost the race: the cached load failed (``_LIB`` is
    False) and ``_SRC_DIR`` holds the source beside a truncated library.
    The helper still yields the reference's library, loaded and declared by
    the reference's own loader, and restores both attributes after."""
    module = MODULES[name]
    real = common.build_reference_native(name) / f"lib{name}.so"
    (tmp_path / f"{name}.cpp").write_bytes((common.ROOT / "native" / f"{name}.cpp").read_bytes())
    # the ELF header only: dlopen refuses it (a longer cut can map pages past
    # its end, and the first touch of one kills the process with SIGBUS)
    (tmp_path / f"lib{name}.so").write_bytes(real.read_bytes()[:64])
    monkeypatch.setattr(module, "_SRC_DIR", str(tmp_path))
    monkeypatch.setattr(module, "_LIB", False)
    assert not module.available()
    monkeypatch.setattr(module, "_LIB", None)
    assert not module.available(), "the reference's loader took a truncated library"

    monkeypatch.setattr(module, "_LIB", False)
    with common.reference_native() as libs:
        assert module.available() and module._lib() is libs[name]
        assert libs[name]._name == str(real)
        if name == "serve_front":
            assert libs[name].sf_start.restype is ctypes.c_void_p
        else:
            x = np.random.default_rng(0).uniform(-0.5, 0.5, 3000).astype(np.float32)
            bio = io.BytesIO()
            wavfile.write(bio, 16000, (x * 32767).astype(np.int16))
            got, sr = module.wav_decode(bio.getvalue())
            assert sr == 16000
            np.testing.assert_allclose(got, x, rtol=0, atol=1e-4)
    assert module._LIB is False and module._SRC_DIR == str(tmp_path)


def test_failed_build_raises_with_gxx_output(tmp_path):
    (tmp_path / "broken.cpp").write_text("int f( { return 0; }\n")
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed for broken.cpp.*error"):
        common.build_reference_native("broken", src=tmp_path / "broken.cpp",
                                      out_root=tmp_path / "out")
    assert not list((tmp_path / "out").rglob("*.so"))


def test_concurrent_builders_build_once(tmp_path, monkeypatch):
    """Six builders at once into an empty directory: g++ runs once, and
    every builder returns a whole library that loads."""
    runs, real_run = [], common.subprocess.run

    def counting_run(cmd, *args, **kwargs):
        if "-o" in cmd:
            runs.append(cmd)
        return real_run(cmd, *args, **kwargs)

    monkeypatch.setattr(common.subprocess, "run", counting_run)
    out, errors, start = [], [], threading.Barrier(6)

    def build():
        try:
            start.wait()
            where = common.build_reference_native("audio_ingest", out_root=tmp_path)
            out.append(where)
            ctypes.CDLL(str(where / "libaudio_ingest.so")).wav_decode
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors and len(runs) == 1 and len(set(out)) == 1
    assert not list(tmp_path.rglob("*.tmp"))

"""The kernel module's two rules, on the CPU with no card and no library:

  * ``kernels.launch`` calls the library's entry point with the current
    stream last, counts one launch in ``LAUNCHES`` on a zero code, and on a
    nonzero code raises naming the kernel and counts nothing;
  * ``kernels.use_plain`` picks the plain version on a CPU tensor, and on
    any tensor or none inside ``kernels.plain_versions()``; the scope
    restores the setting before it, also when its block raises, and
    ``plain_versions(False)`` turns it off inside an outer scope.
"""

from __future__ import annotations

import contextlib

import pytest
import torch

from presight_tpu_torch import kernels

STREAM = 0x5EED


class FakeLibrary:
    """An entry point for every kernel, recording its arguments and returning
    ``code``."""

    def __init__(self, code: int):
        self.code, self.calls = code, []

    def __getattr__(self, name):
        if name not in kernels.KERNELS:
            raise AttributeError(name)

        def entry(*args):
            self.calls.append((name, args))
            return self.code
        return entry


@pytest.fixture
def fake(monkeypatch):
    def install(code):
        library = FakeLibrary(code)
        monkeypatch.setattr(kernels, "_lib", library)
        monkeypatch.setattr(kernels, "stream", lambda: STREAM)
        monkeypatch.setattr(kernels, "LAUNCHES", dict.fromkeys(kernels.KERNELS, 0))
        return library
    return install


def test_launch_passes_the_stream_last_and_counts(fake):
    library = fake(0)
    kernels.launch("msda_fwd", 1, 2.5, None)
    kernels.launch("msda_fwd", 3, 4.5, None)
    assert library.calls == [("msda_fwd", (1, 2.5, None, STREAM)),
                             ("msda_fwd", (3, 4.5, None, STREAM))]
    assert kernels.LAUNCHES == {**dict.fromkeys(kernels.KERNELS, 0), "msda_fwd": 2}


def test_launch_raises_on_an_error_code_and_counts_nothing(fake):
    library = fake(700)
    with pytest.raises(RuntimeError, match=r"bev_pool_bwd: CUDA error 700"):
        kernels.launch("bev_pool_bwd", 7)
    assert library.calls == [("bev_pool_bwd", (7, STREAM))]
    assert not any(kernels.LAUNCHES.values())


@pytest.mark.parametrize("device,scoped,plain", [
    ("cpu", False, True), ("cpu", True, True), ("meta", False, False), ("meta", True, True),
    (None, False, False), (None, True, True)])
def test_use_plain(device, scoped, plain):
    t = None if device is None else torch.empty(2, device=device)
    with kernels.plain_versions() if scoped else contextlib.nullcontext():
        assert kernels.use_plain(t) is plain
    assert kernels.use_plain(t) is (device == "cpu")


def test_plain_versions_restores_the_setting_when_its_block_raises():
    meta = torch.empty(2, device="meta")
    with pytest.raises(ValueError, match="inside"):
        with kernels.plain_versions():
            assert kernels.use_plain(meta)
            raise ValueError("inside")
    assert not kernels.use_plain(meta) and not kernels.use_plain()


def test_plain_versions_off_inside_a_scope():
    meta = torch.empty(2, device="meta")
    with kernels.plain_versions():
        with kernels.plain_versions(False):
            assert not kernels.use_plain(meta) and not kernels.use_plain()
            assert kernels.use_plain(torch.empty(2))
        assert kernels.use_plain(meta)
    assert not kernels.use_plain(meta)

"""The port's trajectory codecs (gromacs_fep_gpu_tpu_torch/io/trrio.py,
io/xtcio.py over native/trrio.cc and native/xtcio.cc, built with g++ at
first use) against the JAX package's: the XTC writer byte-identical to the
golden 3dfcoord blobs of the reference (tests/data/xtc_golden.npz, six
coordinate sets at precisions 1000 and 100) and to JAX's writer on the
same frame; the TRR file byte-identical to JAX's for the same frames with
and without velocities; round trips and multi-frame scans of both
formats."""
import os

import numpy as np
import pytest

from gromacs_fep_gpu_tpu.io import trrio as jtrr
from gromacs_fep_gpu_tpu.io import xtcio as jxtc
from gromacs_fep_gpu_tpu_torch.io import trrio as ttrr
from gromacs_fep_gpu_tpu_torch.io import xtcio as txtc

DATA = os.path.join(os.path.dirname(__file__), "data", "xtc_golden.npz")
BOX = np.diag([4.0, 4.0, 4.0]).astype(np.float32)
CASES = ["mixed12", "water81", "rand300", "tight50", "tiny8", "neg40"]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("prec", [1000, 100])
def test_xtc_bitstream_matches_golden_and_jax(case, prec, tmp_path):
    """The frame is a 16-byte header, the 36-byte box and the 3dfcoord
    block (which starts with natoms)."""
    d = np.load(DATA)
    x = d[f"{case}_p{prec}_x"]
    port, jax_ = str(tmp_path / "port.xtc"), str(tmp_path / "jax.xtc")
    txtc.write_xtc_frame(port, x, BOX, step=3, time=0.006,
                         precision=float(prec))
    jxtc.write_xtc_frame(jax_, x, BOX, step=3, time=0.006,
                         precision=float(prec))
    raw = open(port, "rb").read()
    assert raw[52:] == d[f"{case}_p{prec}_bytes"].tobytes()
    assert raw == open(jax_, "rb").read()


def _frames(seed=4, n=37, k=4):
    rng = np.random.default_rng(seed)
    return [(rng.uniform(0, 3, (n, 3)).astype(np.float32),
             rng.normal(size=(n, 3)).astype(np.float32),
             np.diag(rng.uniform(2.9, 3.1, 3)).astype(np.float32))
            for _ in range(k)]


def test_trr_file_matches_jax_with_and_without_v(tmp_path):
    port, jax_ = str(tmp_path / "port.trr"), str(tmp_path / "jax.trr")
    for i, (x, v, box) in enumerate(_frames()):
        kw = dict(v=v if i % 2 else None, step=10 * i, time=0.02 * i,
                  lam=0.25)
        ttrr.write_trr_frame(port, x, box, **kw)
        jtrr.write_trr_frame(jax_, x, box, **kw)
    assert open(port, "rb").read() == open(jax_, "rb").read()


def test_trr_round_trip_and_scan(tmp_path):
    path = str(tmp_path / "m.trr")
    frames = _frames()
    for i, (x, v, box) in enumerate(frames):
        ttrr.write_trr_frame(path, x, box, v=v if i % 2 else None,
                             f=-v if i == 3 else None, step=10 * i,
                             time=0.02 * i, lam=0.5)
    assert ttrr.scan_trr(path) == (37, 4)
    for i, (x, v, box) in enumerate(frames):
        fr = ttrr.read_trr_frame(path, i, 37)
        assert fr["step"] == 10 * i and fr["lam"] == 0.5
        np.testing.assert_allclose(fr["time"], 0.02 * i, rtol=1e-6)
        np.testing.assert_array_equal(fr["x"], x)
        np.testing.assert_array_equal(fr["box"], box)
        if i % 2:
            np.testing.assert_array_equal(fr["v"], v)
        else:
            assert fr["v"] is None
        assert (fr["f"] is not None) == (i == 3)
    with pytest.raises(IOError):        # more atoms than the buffers hold
        ttrr.read_trr_frame(path, 1, 36)


def test_xtc_round_trip_and_scan(tmp_path):
    """Compressed frames come back within half a precision unit; a frame
    of at most 9 atoms is stored uncompressed (exact)."""
    path = str(tmp_path / "m.xtc")
    frames = _frames(n=60, k=5) + _frames(seed=6, n=60, k=1)
    for i, (x, _, box) in enumerate(frames):
        txtc.write_xtc_frame(path, x, box, step=20 * i, time=0.04 * i,
                             precision=1000.0)
    assert txtc.scan_xtc(path) == (60, 6)
    for i, (x, _, box) in enumerate(frames):
        fr = txtc.read_xtc_frame(path, i, 60)
        assert fr["step"] == 20 * i and fr["precision"] == 1000.0
        np.testing.assert_allclose(fr["box"], box, atol=1e-6)
        np.testing.assert_allclose(fr["x"], x, atol=0.5e-3 + 1e-6)
    small = str(tmp_path / "s.xtc")
    x8 = frames[0][0][:8]
    txtc.write_xtc_frame(small, x8, BOX, step=1)
    np.testing.assert_array_equal(txtc.read_xtc_frame(small, 0, 8)["x"], x8)
    with pytest.raises(IOError):        # more atoms than the buffer holds
        txtc.read_xtc_frame(path, 2, 59)

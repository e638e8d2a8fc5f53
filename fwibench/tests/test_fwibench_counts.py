"""The frozen counts against values worked by hand at the SMARMN and
SMARM2 shapes (r = 4; padded 380 x 186 and 420 x 220; nt 1357 and 1421;
29 and 31 shots; 300 and 340 receivers)."""
import json
import os

import pytest

from fwibench import lib

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = lib.Bench(os.path.dirname(HERE))


def _sizes(config, nt):
    return lib.sizes(json.load(open(os.path.join(
        HERE, "configs", config + ".json"))), nt, {"misfit": 0})


@pytest.mark.parametrize("family,config,nt,kind,ops,nbytes,least_ms", [
    # 29 * 380 * 186 cells * 1355 steps * 36; 4 * (2 * 70680 + 1357 +
    # 3 * 29 * 1357 * 300) bytes
    ("acoustic", "smarmn-acoustic", 1357, "trial", 99_985_341_600,
     142_241_668, 1.4923185),
    # * (36 + 2 + 36 + 6); + 4 * 300 * 106 bytes of gradient
    ("acoustic", "smarmn-acoustic", 1357, "gradient", 222_189_648_000,
     142_368_868, 3.3162634),
    # 31 * 420 * 220 cells * 1420 steps * 159
    ("elastic", "smarm2-elastic", 1421, "trial", 646_724_232_000,
     181_212_164, 9.6526004),
    # * (159 + 244)
    ("elastic", "smarm2-elastic", 1421, "gradient", 1_639_181_544_000,
     181_402_564, 24.4654)])
def test_counts_by_hand(family, config, nt, kind, ops, nbytes, least_ms):
    got = BENCH.count(family).work(kind, _sizes(config, nt))
    assert got == (ops, nbytes)
    rec = {"peaks": lib.peaks("NVIDIA H100 80GB HBM3"), "bench": BENCH,
           "family": family, "sizes": _sizes(config, nt)}
    assert lib.least_seconds(rec, kind) * 1e3 == pytest.approx(least_ms,
                                                               rel=1e-6)


def test_peaks_match_by_name():
    assert lib.peaks("NVIDIA H100 80GB HBM3") == (67.0e12, 3.35e12)
    assert lib.peaks("NVIDIA H100 PCIe") == (51.0e12, 2.0e12)
    assert lib.peaks("NVIDIA A100-SXM4-80GB") is None

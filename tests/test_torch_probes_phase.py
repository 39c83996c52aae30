"""The port's twin of scripts/probe_scatter_cost.py
(scripts/torch_probe_scatter_cost.py), chip_smoke.py's [contact probes]
phase and the no-card rule of every probe twin, on the CPU.

  * each primitive the twin times against numpy on P = 4,096 payload
    rows into M = 9,000 slots: the placements and index_add_ against
    np.add.at (f32 sums of at most a few terms per slot: rtol 1e-6, atol
    1e-6 * max), the gather and searchsorted exactly, the cumsums against
    a float64 cumsum (atol 1e-5 * max|sum|), argsort as a permutation that
    sorts the targets;
  * the phase at 16^2 (32^2 for the crossings), K = 2, held to the JAX
    records at those sizes: on the CPU every band, bitwise check and
    agreement holds, and the only faults are the CPU's (no kernel
    launched); probe_faults and probe_band on synthetic input;
  * each probe twin raises without --device on a machine without a card.
"""

import importlib
import math

import numpy as np
import pytest
import torch

import dissect_support  # noqa: F401  (puts scripts/ and the checkout on sys.path)

import chip_smoke
import torch_probe_scatter_cost as sc

torch.set_num_threads(2)

CPU = torch.device("cpu")
P, M = 4096, 9000
TWINS = ("torch_probe_stiff", "torch_probe_isosort", "torch_probe_damping",
         "torch_probe_contact", "torch_probe_scatter_cost", "torch_probe_crossing_fix")
# The JAX records at the test sizes, from
#   JAX_PLATFORMS=cpu python3 scripts/jax_probe_record.py --scans 16 --stiff 1e3 1e4 --contact 16
SCANS_16 = {16: {1e3: dict(static=224, general=80, jacobi=568, damped=(224, 200, 200, 200),
                           per_axis=200, iso=80),
                 1e4: dict(static=368, general=80, jacobi=632, damped=(368, 352, 360, 352),
                           per_axis=368, iso=80)}}
CONTACT_16 = {16: dict(static=224, general=224)}


@pytest.fixture(scope="module")
def inputs():
    return sc.setup(P, M, CPU)


def _numpy(name, s):
    tgt, srt, v9 = s.tgt.numpy(), s.tgt_sorted.numpy(), s.val9.numpy()
    if name.startswith(("accumulate_rows", "index_add_")):
        width = 1 if "[P,1]" in name else 9
        out = np.zeros((M, width), np.float32)
        np.add.at(out, srt if "sorted" in name else tgt, v9[:, :width])
        return out
    return {"gather [P,9] rows": lambda: v9[tgt % P],
            "cumsum [P,9] (9-minor)": lambda: np.cumsum(v9.astype(np.float64), axis=0),
            "cumsum [9,P] (P-minor)": lambda: np.cumsum(v9.reshape(9, -1).astype(np.float64), axis=1),
            "searchsorted M queries": lambda: np.searchsorted(srt, np.arange(M, dtype=np.int32))}[name]()


@pytest.mark.parametrize("name", list(sc.OPS))
def test_scatter_cost_op(inputs, name):
    got = sc.OPS[name](inputs).numpy()
    if name == "argsort [P] i32":
        assert sorted(got.tolist()) == list(range(P))
        np.testing.assert_array_equal(inputs.tgt.numpy()[got], np.sort(inputs.tgt.numpy()))
        return
    want = _numpy(name, inputs)
    assert got.shape == want.shape
    if name.startswith("cumsum"):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    elif want.dtype.kind == "f":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    else:
        np.testing.assert_array_equal(got, want)


def test_scatter_cost_main(capsys):
    assert sc.main(["--device", "cpu", "--p", str(P), "--m", str(M)]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == f"P={P} M={M} deterministic=False" and out[1].startswith("device: cpu")
    assert len(out) == 2 + len(sc.OPS)
    for name, line in zip(sc.OPS, out[2:]):
        assert line.startswith(name)
        ms = float(line[44:].split()[0])
        assert math.isfinite(ms) and ms > 0


def test_chip_smoke_probe_gates():
    """The phase through the twins' module functions at the test sizes: on
    the CPU the only faults are the kernels that never launch. On the card
    the same gates must all hold."""
    assert chip_smoke.PROBES == {"scans": 128, "contact": 256, "crossing_fix": 1024}
    assert chip_smoke.PROBE_STIFFS == (1e3, 1e4)
    counts, faults = chip_smoke.run_contact_probes(
        {"scans": 16, "contact": 16, "crossing_fix": 32}, ks={"contact": 2, "crossing_fix": 2},
        scan_records_by_side=SCANS_16, contact_records=CONTACT_16, device="cpu",
        scatter_sizes=(P, M))
    assert faults == [f"{k} never launched" for k in chip_smoke.DISSECT_KERNELS]
    assert set(counts) == {"probe stiff 16", "probe damping 16", "probe isosort 16",
                           "probe contact 16", "probe crossing_fix 32", "probe scatter_cost"}


def test_probe_faults_and_bands():
    assert chip_smoke.probe_band(384, 1e3) == (368, 400)
    assert chip_smoke.probe_band(1136, 1e3) == pytest.approx((1101.92, 1170.08))
    assert chip_smoke.probe_band(112, 1e6) == (96, 128)
    assert chip_smoke.probe_band(5480, 1e6) == pytest.approx((4822.4, 6137.6))
    rec = chip_smoke.scan_records(chip_smoke.JAX_RECORD_PROBE_SCANS[128][1e4])
    assert rec[("damping", 0.25)] == 944 and rec[("isosort", "axis")] == 1160
    assert rec[("stiff", "jacobi")] == rec[("damping", "jacobi")] == rec[("isosort", "jacobi")]
    launched = {k: 1 for k in chip_smoke.DISSECT_KERNELS}
    ok = chip_smoke.probe_faults([("a", 376, 384, 1e3)], {"x": True}, launched, {"m": 1.0})
    assert ok == []
    bad = chip_smoke.probe_faults([("a", 416, 384, 1e3), ("b", 1136, 1136, 1e4)],
                                  {"x": False}, {**launched, "symv96": 0},
                                  {"m": float("nan")})
    assert len(bad) == 4 and bad[0].startswith("a: 416 iterations outside [368, 400]")
    assert "x does not hold" in bad and "symv96 never launched" in bad


@pytest.mark.parametrize("name", TWINS)
def test_twin_raises_without_card(name, monkeypatch):
    """Without --device a twin runs on the card, and raises where there is
    none instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        importlib.import_module(name).main([])

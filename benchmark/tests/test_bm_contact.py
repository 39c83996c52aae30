"""The benchmark's contact side on the CPU: a tiny fold cell (a 32 x 32
sheet with an 8-column hem) end to end, the reference's contact set against
brute force and its weights against the distance's gradient, the control
and the contact faults that must turn `correct` false, a full broad-phase
cell failing its frame, and the drape cells' inputs as they were.

The program's edge-edge weights are those of its closest points mirrored
(bm_support.closest_point_ee_weights), which fails the comparison by itself
(test_the_programs_ee_weights_fail_the_comparison); the tests that need a
sound program run with them put right (the `sound` fixture).

Run: python -m pytest benchmark/tests -q   (the fold runs take ~30-150 s each)
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import bm_support as bm  # noqa: E402

torch.set_num_threads(2)
sys.path.insert(0, bm.REPO)

from benchmark import contact, scene  # noqa: E402
from benchmark.meshes import delaunay, grid  # noqa: E402

CONFIG = "cloth_grid_1m_tiny"
FORBIDDEN = {"jax", "jaxlib", "flax", "precond_tpu"}


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    root = bm.tiny_checkout(str(tmp_path_factory.mktemp("checkout")))
    bm.add_cell(root, CONFIG, "fold_band", bm.FOLD_LIMITS)
    return root


FOLD = f"{CONFIG}.fold_band"


@pytest.fixture
def sound(monkeypatch):
    """The program with its edge-edge weights put right."""
    from precond_tpu_torch.models import simulator

    monkeypatch.setattr(simulator, "build_stencils",
                        bm.closest_point_ee_weights(simulator.build_stencils))


def _calibrate():
    spec = importlib.util.spec_from_file_location(
        "bm_calibrate", os.path.join(bm.REPO, "benchmark", "calibrate.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("trace", [False, True])
def test_fold_cell_runs_and_is_correct_on_the_cpu(checkout, sound, trace):
    result, lines = bm.run_cpu(checkout, FOLD, trace=trace)
    assert result["correct"], lines
    check = result["check"]
    assert set(check) == set(bm.FOLD_LIMITS)
    # the port and the float64 reference agree far inside the limits
    assert check["contact_apply_gap"]["value"] < 2e-4, lines
    assert check["contact_residual"]["value"] < 5e-4, lines
    assert check["contact_count_gap"]["value"] == 0
    assert result["failed"] == 0 and check["detect_overflow"]["value"] == 0
    notes = [ln for ln in lines if ln.startswith("contact frame ")]
    assert len(notes) == 3 and all(" rows=0" not in ln for ln in notes), notes
    assert result["device"]["platform"] == "cpu"
    json.dumps(result, allow_nan=False)


@pytest.mark.parametrize("fault", ["control_bf16", "contact_spmv_zero", "m_without_contact",
                                   "b_without_contact"])
def test_control_and_contact_faults_fail_the_comparison(checkout, sound, monkeypatch, fault):
    from precond_tpu_torch.models import simulator

    overrides = {}
    if fault == "control_bf16":
        overrides = dict(inverse_dtype="bfloat16")
    else:
        name, wrap, needs_contact = _calibrate().FAULTS[fault]
        assert needs_contact
        monkeypatch.setattr(simulator, name, wrap(getattr(simulator, name)))
    result, lines = bm.run_cpu(checkout, FOLD, **overrides)
    assert not result["correct"], lines


def test_the_programs_ee_weights_fail_the_comparison(checkout):
    """The program as it stands: its edge-edge stencils weigh each edge's
    vertices the wrong way round, and the contact rows read it. The set it
    finds, its detection and its convergence are sound."""
    result, lines = bm.run_cpu(checkout, FOLD)
    assert not result["correct"], lines
    check = result["check"]
    assert check["contact_residual"]["value"] > 10 * check["contact_residual"]["limit"], lines
    for k in ("contact_count_gap", "detect_overflow", "unconverged", "update_mismatch"):
        assert check[k]["value"] == 0, lines


def test_an_extra_contact_fails_the_count(checkout, sound, monkeypatch):
    """Edge-face pairs found out to 1.15 thresholds (those at 0.58 spacings,
    beyond the threshold's 0.55) are contacts the reference does not have:
    the live count departs from it."""
    from precond_tpu_torch.models import collision

    real = collision.detect_ef_grid

    def wide(x, edges, faces, threshold, **kw):
        return real(x, edges, faces, threshold=1.15 * threshold, **kw)

    monkeypatch.setattr(collision, "detect_ef_grid", wide)
    result, lines = bm.run_cpu(checkout, FOLD)
    assert not result["correct"], lines
    assert result["check"]["contact_count_gap"]["value"] > 0, lines


def test_a_full_grid_cell_fails_the_frame(checkout, sound, tmp_path):
    """A broad-phase cell over its cap (cap 1) makes every frame's contact
    set wrong: the frames count as failed and `correct` is false."""
    import shutil

    root = str(tmp_path / "cap1")
    shutil.copytree(checkout, root, ignore=shutil.ignore_patterns("cache"))
    cell = bm.add_cell(root, CONFIG, "fold_band", bm.FOLD_LIMITS, cell_cap=1)
    result, lines = bm.run_cpu(root, cell)
    assert not result["correct"], lines
    assert result["failed"] >= 1
    assert result["check"]["detect_overflow"]["value"] >= 1


# ---- the reference's contact set ------------------------------------------------

def _folded(side, seed, wobble=0.0):
    """A grid sheet with the fold traffic's hem (a quarter of the columns),
    its positions moved by up to `wobble` spacings from the seed."""
    cfg = json.load(open(os.path.join(bm.REPO, "benchmark", "configs", "cloth_grid_1m.json")))
    m = grid.build(dict(cfg["mesh"], side=side))
    traffic = json.load(open(os.path.join(bm.REPO, "benchmark", "traffic", "fold_band.json")))
    traffic["fold"]["columns"] = side // 4
    sc = scene.make(traffic, m, seed)
    h = float(m["spacing"])
    x = torch.as_tensor(sc.rest, dtype=torch.float64)
    x += wobble * h * (2 * torch.rand(x.shape, generator=torch.Generator().manual_seed(seed),
                                      dtype=torch.float64) - 1)
    return m, x, sc.contact


def _brute_force(m, x, threshold):
    """Every VF, EE and EF pair nearer than `threshold`, from all pairs."""
    faces = torch.as_tensor(m["faces"]).long()
    edges = torch.as_tensor(m["edges"])[:, :2].long()
    fa, fb, fc = (x[faces[:, k]] for k in range(3))
    ea, eb = x[edges[:, 0]], x[edges[:, 1]]
    mid = 0.5 * (ea + eb)
    out = set()

    def add(kind, q, c, dist, ok, ids):
        keep = ok & (dist < threshold)
        for row in ids[keep].tolist():
            out.add((kind, tuple(row)))

    for q in torch.arange(x.shape[0]).split(256):
        qq, f = (t.reshape(-1) for t in torch.meshgrid(q, torch.arange(len(faces)), indexing="ij"))
        bary = contact.point_triangle(x[qq], fa[f], fb[f], fc[f])
        dist = (x[qq] - contact._at(bary, fa[f], fb[f], fc[f])).norm(dim=-1)
        add("VF", qq, f, dist, ~(faces[f] == qq[:, None]).any(-1),
            torch.cat([faces[f], qq[:, None]], 1))
    for q in torch.arange(len(edges)).split(128):
        qq, e = (t.reshape(-1) for t in torch.meshgrid(q, torch.arange(len(edges)), indexing="ij"))
        s, t = contact.segment_segment(ea[qq], eb[qq], ea[e], eb[e])
        g = (ea[qq] + s[:, None] * (eb[qq] - ea[qq])) - (ea[e] + t[:, None] * (eb[e] - ea[e]))
        shares = (edges[qq][:, :, None] == edges[e][:, None, :]).any(-1).any(-1)
        add("EE", qq, e, g.norm(dim=-1), (e > qq) & ~shares, torch.cat([edges[qq], edges[e]], 1))
        qq, f = (t.reshape(-1) for t in torch.meshgrid(q, torch.arange(len(faces)), indexing="ij"))
        bary = contact.point_triangle(mid[qq], fa[f], fb[f], fc[f])
        dist = (mid[qq] - contact._at(bary, fa[f], fb[f], fc[f])).norm(dim=-1)
        shares = (edges[qq][:, :, None] == faces[f][:, None, :]).any(-1).any(-1)
        add("EF", qq, f, dist, ~shares, torch.cat([edges[qq], faces[f]], 1))
    return out


@pytest.mark.parametrize("side,wobble", [(16, 0.0), (16, 0.3), (32, 0.0), (32, 0.3)])
def test_reference_contact_set_is_the_brute_force_set(side, wobble):
    m, x, con = _folded(side, 2**31 + side, wobble)
    found, undecided, info = contact.find(x, m["faces"], m["edges"], con.threshold,
                                          con.per_primitive_cap, 0.0)
    assert info["capped"] == 0
    width = {"EF": 5, "EE": 4, "VF": 4}
    got = {(contact.KINDS[k], tuple(row[:width[contact.KINDS[k]]]))
           for k, row in zip(found.kind.tolist(), found.idx.tolist())}
    assert len(got) == found.idx.shape[0]
    want = _brute_force(m, x, con.threshold)
    assert got == want
    assert {k for k, _ in want} == {"VF", "EE", "EF"}


def _pair_distance(kind, idx, x):
    """The exact closest-point distance of one stencil's pair at positions x."""
    p = [x[i] for i in idx]
    if kind == "VF":
        bary = contact.point_triangle(p[3], p[0], p[1], p[2])
        return (p[3] - contact._at(bary, p[0], p[1], p[2])).norm()
    if kind == "EE":
        s, t = contact.segment_segment(p[0], p[1], p[2], p[3])
        return ((p[0] + s * (p[1] - p[0])) - (p[2] + t * (p[3] - p[2]))).norm()
    mid = 0.5 * (p[0] + p[1])
    bary = contact.point_triangle(mid, p[2], p[3], p[4])
    return (mid - contact._at(bary, p[2], p[3], p[4])).norm()


@pytest.mark.parametrize("kind", contact.KINDS)
def test_stencil_weights_are_the_distance_gradient(kind):
    """Each stencil's weight times its direction is the gradient of its
    pair's distance by that vertex (central differences in float64), on
    pairs of two random triangles: the weights follow from the closest
    points, whatever convention a program uses."""
    faces = np.array([[0, 1, 2], [3, 4, 5]])
    edges = np.array([[0, 1], [1, 2], [0, 2], [3, 4], [4, 5], [3, 5]])
    width = {"EF": 5, "EE": 4, "VF": 4}[kind]
    seen = 0
    for seed in range(6):
        g = torch.Generator().manual_seed(seed)
        x = torch.rand((6, 3), generator=g, dtype=torch.float64)
        x[3:, 2] += 0.2
        st, _, _ = contact.find(x, faces, edges, 0.6, 32, 0.0)
        for k, idx, w, d in zip(st.kind.tolist(), st.idx, st.w, st.d):
            if contact.KINDS[k] != kind:
                continue
            seen += 1
            idx = idx[:width].tolist()
            for slot, v in enumerate(idx):
                grad = torch.zeros(3, dtype=torch.float64)
                for c in range(3):
                    hi, lo = x.clone(), x.clone()
                    hi[v, c] += 1e-7
                    lo[v, c] -= 1e-7
                    grad[c] = (_pair_distance(kind, idx, hi) - _pair_distance(kind, idx, lo)) / 2e-7
                assert torch.allclose(grad, w[slot] * d, atol=1e-6), (seed, idx, slot)
    assert seen >= 3


def test_closest_points_are_the_nearest_sampled_points():
    """The narrow phase against the nearest of a dense sample of each
    primitive's points, on random triangles and segments."""
    g = torch.Generator().manual_seed(7)
    p, a, b, c = (torch.rand((200, 3), generator=g, dtype=torch.float64) for _ in range(4))
    bary = contact.point_triangle(p, a, b, c)
    assert torch.allclose(bary.sum(-1), torch.ones(200, dtype=torch.float64))
    assert bool((bary >= -1e-12).all())
    got = (p - contact._at(bary, a, b, c)).norm(dim=-1)
    u, v = torch.meshgrid(*(torch.linspace(0, 1, 201, dtype=torch.float64),) * 2, indexing="ij")
    inside = (u + v <= 1).reshape(-1)
    u, v = u.reshape(-1)[inside], v.reshape(-1)[inside]
    pts = (1 - u - v)[None, :, None] * a[:, None] + u[None, :, None] * b[:, None] \
        + v[None, :, None] * c[:, None]
    sampled = (p[:, None] - pts).norm(dim=-1).amin(1)
    assert bool((got <= sampled + 1e-12).all()) and bool((sampled - got < 5e-3).all())

    a0, a1, b0, b1 = (torch.rand((200, 3), generator=g, dtype=torch.float64) for _ in range(4))
    b1[:20] = b0[:20] + (a1[:20] - a0[:20]) * 0.7   # parallel pairs
    s, t = contact.segment_segment(a0, a1, b0, b1)
    assert bool(((s >= 0) & (s <= 1) & (t >= 0) & (t <= 1)).all())
    got = ((a0 + s[:, None] * (a1 - a0)) - (b0 + t[:, None] * (b1 - b0))).norm(dim=-1)
    w = torch.linspace(0, 1, 401, dtype=torch.float64)
    pa = a0[:, None] + w[None, :, None] * (a1 - a0)[:, None]
    pb = b0[:, None] + w[None, :, None] * (b1 - b0)[:, None]
    sampled = (pa[:, :, None] - pb[:, None]).norm(dim=-1).flatten(1).amin(1)
    assert bool((got <= sampled + 1e-12).all()) and bool((sampled - got < 5e-3).all())


# ---- the drape cells, as before ------------------------------------------------

# SHA-256 of x0, v0 and pinned and the frame choices of the drape traffic's
# scene on 32 x 32 sheets, as the generator before the fold and contact
# blocks made them
DRAPE_DIGESTS = {
    ("grid", 2**31 + 7): "db91a448bdfd518a0a22b8ff154ab5be2041e401e1cc993fb3b9b7fa922adc82",
    ("grid", 5): "c5c18850d9f0b4a734eeabea4cd1ef3dbe4ca13ef4a645f5a9c493424fdd4ffc",
    ("delaunay", 2**31 + 7): "114a5f2f78963f991c10b208b470f5e0dc13817d1a72e26faf8178b62399f601",
    ("delaunay", 5): "9831cc7f0f98b186a5e3c81348cf961fc2c11e18d088d87b73d35ddbd54e40c0",
}


@pytest.mark.parametrize("kind,seed", sorted(DRAPE_DIGESTS))
def test_drape_inputs_are_bit_for_bit_unchanged(kind, seed, monkeypatch):
    from benchmark import harness
    from precond_tpu_torch import SchwarzConfig
    from precond_tpu_torch.models import simulator

    name = {"grid": "cloth_grid_1m", "delaunay": "cloth_delaunay_1m"}[kind]
    cfg = json.load(open(os.path.join(bm.REPO, "benchmark", "configs", name + ".json")))
    cfg["mesh"]["side"] = bm.TINY_SIDE
    m = {"grid": grid, "delaunay": delaunay}[kind].build(cfg["mesh"])
    m.update(mass=float(cfg["mass"]), dt=float(cfg["dt"]))
    traffic = json.load(open(os.path.join(bm.REPO, "benchmark", "traffic", "drape.json")))
    sc = scene.make(traffic, m, seed)
    h = hashlib.sha256()
    for arr in (sc.x0, sc.v0, sc.pinned):
        h.update(np.ascontiguousarray(arr).tobytes())
    h.update(repr((sc.gravity, sc.tol, sc.max_iters, sc.episode_frames, sc.warm_frames,
                   sc.checked, sc.traced, sc.labelled)).encode())
    assert h.hexdigest() == DRAPE_DIGESTS[(kind, seed)]
    assert sc.contact is None and sc.rest is sc.x0

    got = {}

    def record(mesh, cfg_, **kw):
        got.update(mesh=mesh, cfg=cfg_, kw=kw)

    monkeypatch.setattr(simulator, "ClothSim", record)
    harness.make_sim(m, cfg, sc, torch.device("cpu"))
    assert set(got["kw"]) == {"gravity", "pinned", "tol", "max_iters", "device"}
    assert got["cfg"] == SchwarzConfig(**cfg["schwarz"])
    pos = got["mesh"].positions
    assert pos.dtype == m["positions"].dtype and np.array_equal(pos, m["positions"])


def test_a_fold_run_loads_no_jax(checkout):
    code = (f"import json, sys, time, torch\n"
            f"sys.path.insert(0, {checkout!r}); sys.path.insert(1, {bm.REPO!r})\n"
            f"sys.path.insert(2, {os.path.dirname(os.path.abspath(__file__))!r})\n"
            "torch.set_num_threads(2)\n"
            "import bm_support\n"
            "from precond_tpu_torch.models import simulator\n"
            "simulator.build_stencils = bm_support.closest_point_ee_weights("
            "simulator.build_stencils)\n"
            "from benchmark import harness\n"
            f"r, _ = harness.run({checkout!r}, {FOLD!r}, 11, 0.5, False, torch.device('cpu'), "
            "time.perf_counter())\nassert r['correct'], r\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=900, cwd=checkout)
    assert out.returncode == 0, out.stderr[-3000:]
    found = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "precond_tpu_torch" in found
    assert not found & FORBIDDEN

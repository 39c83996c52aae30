"""The port's DCP checkpoint (io/sharded.py) on one process, mirroring
tests/test_sharded_checkpoint.py: the solver round trip, the fingerprint
refusal, and a restore into a template's dtype and device."""

import dataclasses

import numpy as np
import pytest
import torch

from precond_tpu_torch import SchwarzConfig, SchwarzPreconditioner
from precond_tpu_torch.io import sharded as shio
from precond_tpu_torch.models import cloth
from precond_tpu_torch.ops.cuda.packed_symv import PackedInverse

torch.set_num_threads(2)


def _solver(cfg=SchwarzConfig(), n=16):
    mesh = cloth.make_grid(n, n, z_wave=0.02)
    pre = SchwarzPreconditioner(cfg, device="cpu")
    pre.allocate(mesh.positions)
    pre.prepare(cloth.assemble_system(mesh, device="cpu"))
    return pre


def _same_state(a, b):
    for fa, fb in zip(a, b):
        if isinstance(fa, tuple):
            assert type(fa) is type(fb)
            _same_state(fa, fb)
        elif isinstance(fa, int):
            assert fa == fb and isinstance(fb, int)
        else:
            assert fa.dtype == fb.dtype and torch.equal(fa, fb)


@pytest.mark.parametrize("cfg", [SchwarzConfig(), SchwarzConfig(inverse_dtype="bfloat16"),
                                 SchwarzConfig(symv_kernel="packed", packed_symv_block_b=128)],
                         ids=["dense_f32", "dense_bf16", "packed"])
def test_solver_roundtrip_and_fingerprint(tmp_path, cfg):
    pre = _solver(cfg)
    n = pre.maps.sorted_to_orig.shape[0]
    x = torch.ones((n, 3))
    path = str(tmp_path / "ckpt")
    shio.save_solver_sharded(path, pre, x=x)

    pre2 = SchwarzPreconditioner(cfg, device="cpu")
    pre2.allocate(np.zeros((n, 3), np.float32))
    x2 = shio.load_solver_sharded(path, pre2)
    assert torch.equal(x2, x)
    assert pre2.frame_index == pre.frame_index
    _same_state(pre.state, pre2.state)
    _same_state(pre.maps, pre2.maps)
    r = torch.as_tensor(np.random.default_rng(0).standard_normal((n, 3)).astype(np.float32))
    assert torch.equal(pre2.apply(r), pre.apply(r))

    # config mismatch must refuse
    pre3 = SchwarzPreconditioner(dataclasses.replace(cfg, max_applied_levels=2), device="cpu")
    pre3.allocate(np.zeros((n, 3), np.float32))
    with pytest.raises(ValueError, match="config mismatch"):
        shio.load_solver_sharded(path, pre3)
    # so must a mesh of another size
    pre4 = SchwarzPreconditioner(cfg, device="cpu")
    pre4.allocate(np.zeros((n // 2, 3), np.float32))
    with pytest.raises(ValueError, match="mesh mismatch"):
        shio.load_solver_sharded(path, pre4)


def test_packed_nb_stays_an_int(tmp_path):
    pre = _solver(SchwarzConfig(symv_kernel="packed", packed_symv_block_b=128))
    path = str(tmp_path / "ckpt")
    shio.save_solver_sharded(path, pre)
    tree = shio.load_tree(path)   # no template: built from the metadata
    assert tree["state"]["inv96"]["nb"] == pre.state.inv96.nb
    assert isinstance(tree["state"]["inv96"]["nb"], int)
    assert tree["state"]["inv96"]["__type__"] == "PackedInverse"
    pre2 = SchwarzPreconditioner(pre.cfg, device="cpu")
    shio.load_solver_sharded(path, pre2)
    assert isinstance(pre2.state.inv96, PackedInverse) and isinstance(pre2.state.inv96.nb, int)


def test_restore_into_template_dtype_and_device(tmp_path):
    a = torch.arange(8 * 32 * 3, dtype=torch.float32).reshape(8 * 32, 3)
    h = torch.arange(10, dtype=torch.float32).to(torch.bfloat16)
    path = str(tmp_path / "tree")
    shio.save_tree(path, {"a": a, "nested": {"h": h, "step": 7}})
    out = shio.load_tree(path)
    assert torch.equal(out["a"], a) and out["a"].device.type == "cpu"
    assert out["nested"]["h"].dtype == torch.bfloat16 and torch.equal(out["nested"]["h"], h)
    assert out["nested"]["step"] == 7
    template = {"a": torch.zeros((8 * 32, 3), dtype=torch.float64, device="cpu"),
                "nested": {"h": torch.zeros(10, dtype=torch.bfloat16), "step": 0}}
    out = shio.load_tree(path, template)
    assert out["a"].dtype == torch.float64 and out["a"].device == template["a"].device
    np.testing.assert_array_equal(out["a"].numpy(), a.numpy())
    assert out["nested"]["step"] == 7
    assert not template["a"].any()   # the template itself is left as it was

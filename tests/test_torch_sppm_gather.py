"""SPPM's photon gather (integrators/sppm.py::gather): the kernel's
contract on the CPU, and the kernel (csrc/sppm_gather.cu) against its
plain twin `gather_plain` on the card.

The file imports neither jax nor pbrt_tpu, so its card tests run on a
machine without JAX (README: "PyTorch/CUDA port").

On the CPU: the kernel's order emulated in numpy (visible-point-major,
photons ascending, d2 = (dx*dx + dy*dy) + dz*dz with each operation
rounded to f32, no FMA) against gather_plain, on a synthetic batch of
the edge cases (kernel_workloads.gather_cases: V = 1,000 and P = 3,001,
dead photons, invalid points, duplicate positions, exact ties d2 == r2)
and on the 12x12 scene of tests/test_torch_sppm.py: M equal on every
point, tau_add within 1e-5 relative (the same hits summed in another
order: every term is positive, so no cancellation); `gather` on CPU
tensors is gather_plain and launches nothing.

On the card, the same batches: M equal but on points with a pair whose
d2 lies within 4 ulp of r2 (kernel_workloads.gather_near_ties: the card's
reduction may sum d2 in another order; none are expected), tau_add within
1e-5 relative where M is equal; the inputs left as they were; two
launches equal bit for bit; one launch a call, four an SPPM iteration at depth 5 and no call of the plain
loop; and the wrapper's raises.
"""
import numpy as np
import pytest
import torch

from pbrt_tpu_torch.cameras import projective
from pbrt_tpu_torch.core import transform as tfm
from pbrt_tpu_torch.integrators import sppm
from pbrt_tpu_torch.samplers.samplers import SamplerConfig
from pbrt_tpu_torch.scene.ir import MaterialSpec, SceneBuilder
from pbrt_tpu_torch.tools import kernel_workloads as kw

W = H = 12
CFG = ("independent", 0, 4)
PHOTONS = 4096
DEPTH = 4
RADIUS = 0.5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def indirect_scene(device):
    """tests/test_sppm.py's scene, built by the port: a downward light quad
    (radiance 10) over a floor and a back wall of kd 0.7 (each lights the
    other), viewed from (0, -7, 3) at 45 degrees by `indirect_camera`."""
    b = SceneBuilder()
    white = b.add_material(MaterialSpec(kd=np.full(31, 0.7, np.float32)))
    black = b.add_material(MaterialSpec())
    li = b.add_area_light(np.full(31, 10.0, np.float32))
    b.add_triangle_mesh([[-1, -1, 4], [1, 1, 4], [1, -1, 4], [-1, 1, 4]],
                        [[0, 1, 2], [0, 3, 1]], black, light_id=li)
    b.add_triangle_mesh([[-4, -4, 0], [4, -4, 0], [4, 4, 0], [-4, 4, 0]],
                        [[0, 1, 2], [2, 3, 0]], white)
    b.add_triangle_mesh([[-4, 4, 0], [4, 4, 0], [4, 4, 6], [-4, 4, 6]],
                        [[0, 2, 1], [2, 0, 3]], white)
    return b.build(device)


def indirect_camera(device):
    return projective.make_perspective(
        tfm.look_at([0, -7, 3], [0, 0, 1.5], [0, 0, 1]), 45.0, W, H,
        device=device)


def scene_batches(device):
    """The 12x12 scene's gather calls (bounces 1-3 of 4)."""
    return kw.gather_batches(indirect_scene(device), indirect_camera(device),
                             SamplerConfig(*CFG), W, H, PHOTONS, DEPTH,
                             RADIUS)


def batches(kind, device):
    if kind == "synthetic":
        return [kw.gather_cases(device)]
    return scene_batches(device)


def emulate(vp_p, vp_valid, r2, p, alive, beta, tau_add, M):
    """The kernel's arithmetic and order in numpy f32."""
    vp, pp = vp_p.numpy(), p.numpy()
    d = [vp[:, None, k] - pp[None, :, k] for k in range(3)]
    d2 = (d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]
    assert d2.dtype == np.float32
    hit = ((d2 <= r2.numpy()[:, None]) & vp_valid.numpy()[:, None]
           & alive.numpy()[None, :])
    tau, m, b = tau_add.numpy().copy(), M.numpy().copy(), beta.numpy()
    for v, q in zip(*np.nonzero(hit)):    # point-major, photons ascending
        tau[v] += b[q]
        m[v] += np.float32(1)
    return tau, m, int(hit.sum())


def assert_close(tau, M, tau_ref, M_ref, skip=None):
    """M equal but on `skip`; tau_add within 1e-5 relative where M is."""
    same = M == M_ref
    if skip is not None:
        assert (same | skip).all()
    assert np.allclose(tau[same], tau_ref[same], rtol=1e-5, atol=1e-30)


@pytest.mark.parametrize("kind", ["synthetic", "scene"])
def test_kernel_order_matches_plain(kind):
    n_hits = 0
    for args in batches(kind, "cpu"):
        tau, M, hits = emulate(*args)
        tau_ref, M_ref = (x.numpy() for x in sppm.gather_plain(*args))
        assert (M == M_ref).all()
        assert_close(tau, M, tau_ref, M_ref)
        n_hits += hits
    assert n_hits > 100


def test_synthetic_cases_are_there():
    """The edge cases gather_cases promises, each present: exact ties that
    count, dead photons and invalid points on which a photon sits."""
    vp_p, vp_valid, r2, p, alive, *_ = kw.gather_cases("cpu")
    d2 = ((vp_p[:, None, :] - p[None, :, :]) ** 2).sum(-1)
    live = vp_valid[:, None] & alive[None, :]
    tie = (d2 == r2[:, None]) & (d2 > 0)
    assert int((tie & live).sum()) > 50
    assert int(((d2 == 0) & ~alive[None, :] & vp_valid[:, None]).sum()) > 5
    assert int(((d2 == 0) & alive[None, :] & ~vp_valid[:, None]).sum()) > 5
    assert not kw.gather_near_ties(vp_p, vp_valid, r2, p, alive).any()


def test_gather_on_cpu_is_plain():
    args = kw.gather_cases("cpu")
    before = [a.clone() for a in args]
    sppm.LAUNCHES["sppm_gather"] = 0
    out = sppm.gather(*args)
    ref = sppm.gather_plain(*args)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    assert all(torch.equal(a, b) for a, b in zip(args, before))
    assert sppm.LAUNCHES["sppm_gather"] == 0


def test_gather_refuses_mixed_devices():
    args = list(kw.gather_cases("cpu"))
    args[5] = args[5].to("meta")
    with pytest.raises(ValueError):
        sppm.gather(*args)


# --- on the card -----------------------------------------------------------

@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    from pbrt_tpu_torch.ops import cuda_kernels
    try:
        cuda_kernels._nvcc()
    except RuntimeError:
        pytest.skip("needs nvcc to build the kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["synthetic", "scene"])
def test_kernel_matches_plain_on_card(device, kind):
    n_near = n_hits = 0
    for args in batches(kind, device):
        tau_ref, M_ref = sppm.gather_plain(*args)
        before = [a.clone() for a in args]
        n0 = sppm.LAUNCHES["sppm_gather"]
        tau, M = sppm.gather(*args)
        assert sppm.LAUNCHES["sppm_gather"] == n0 + 1
        assert all(torch.equal(a, b) for a, b in zip(args, before))
        near = kw.gather_near_ties(*args[:5]).cpu().numpy()
        assert_close(tau.cpu().numpy(), M.cpu().numpy(),
                     tau_ref.cpu().numpy(), M_ref.cpu().numpy(), skip=near)
        n_near += int(near.sum())
        n_hits += int((M - args[7]).sum())
    assert n_near == 0
    assert n_hits > 100


@pytest.mark.cuda
def test_two_launches_equal_bit_for_bit(device):
    for args in batches("synthetic", device) + batches("scene", device):
        a = sppm.gather(*args)
        b = sppm.gather(*args)
        assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
def test_an_iteration_launches_the_kernel_four_times(device):
    scene = indirect_scene(device)
    cam = indirect_camera(device)

    def refuse(*a):
        raise AssertionError("gather_plain ran on CUDA tensors")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sppm, "gather_plain", refuse)
        sppm.LAUNCHES["sppm_gather"] = 0
        L = sppm.render_sppm(scene, cam, W, H, SamplerConfig(*CFG),
                             n_iterations=2, max_depth=5)
    assert sppm.LAUNCHES["sppm_gather"] == 2 * 4
    assert torch.isfinite(L).all() and float(L.sum()) > 0


@pytest.mark.cuda
def test_wrapper_raises_on_card(device):
    args = list(kw.gather_cases(device))
    bad = {"dtype": (0, args[0].double()),
           "shape": (5, args[5][:, :30].contiguous()),
           "contiguity": (3, args[3].t().contiguous().t()),
           "valid dtype": (1, args[1].to(torch.uint8)),
           "mixed devices": (2, args[2].cpu())}
    for what, (i, x) in bad.items():
        a = list(args)
        a[i] = x
        with pytest.raises((TypeError, ValueError)):
            sppm.gather(*a)

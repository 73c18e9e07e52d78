"""The water-glass configuration of the benchmark (``portbench/``): the
program against the family's plain reference
(``portbench/reference/render_water_glass.py``) at a size the CPU holds,
the reference's pieces against the program's on seeded rays (plane and
cube uv and tangent frames, dielectric children, atlas wraparound), and
planted faults that must read ``correct`` false.

The reference and the stand-in texels (``portbench/reference/texels.py``)
are loaded from ``portbench/``, which goes on the path.  On the CPU the
program's sweep runs its plain version and both sides run the same float32
arithmetic, so the frames agree bit for bit; the comparisons below hold
the pieces to 1e-6 (a few ulps of the unit vectors and uv), the frame to
the cell's own limits."""

import copy
import os
import sys

import pytest
import torch

import portrayer_tpu_torch as T
from portrayer_tpu_torch.ops import intersect as I
from portrayer_tpu_torch.ops import shade as S
from portrayer_tpu_torch.ops import trace as tr

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "portbench")
for p in (BENCH, os.path.join(BENCH, "tests")):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness import bench, family  # noqa: E402
from reference import render_water_glass as R  # noqa: E402
from reference.render import Rays  # noqa: E402

from _small import small_cell  # noqa: E402

CELL = "water-glass.spp100"
SEED = 2**31 + 2026


def run(data, traffic, limits):
    return bench.run_cell(T, data, traffic, limits, SEED, 0.0, False, "cpu", 0.0)


def test_the_program_matches_the_reference_at_the_cpu_size():
    """48x27 at 6 spp through Image.render on flatten_scene tables: within
    the cell's limits, no child dropped, refracted children counted."""
    _, data, traffic, limits = small_cell(CELL)
    rec = run(data, traffic, limits)
    assert rec["correct"], rec["checks"]
    assert rec["checks"]["dropped_w"] == {"value": 0.0, "limit": 0.0}
    assert sum(int(s.refr[1:].sum()) for s in rec["stats"]) > 0


def _tables():
    data = bench.Spec().config("water-glass")
    scene, _, _, _ = family.lookup(data).build(T, data)
    cfg = T.RenderConfig(device="cpu")
    return T.flatten_scene(scene, "cpu"), R.tables(data, "cpu"), cfg


def _rays_at(sc, node, n, gen, inside=False):
    """n seeded rays at `node`: from points on a sphere of radius 1.5
    around it in its frame (inside it with `inside`) towards random points
    of its unit box."""
    m = torch.linalg.inv(torch.cat([sc.inv[node].double(),
                                    torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=torch.float64)]))
    local = lambda k, r: (torch.rand((n, 3), generator=gen, dtype=torch.float64) - 0.5) * k + r
    to_world = lambda p: (m[:3, :3] @ p.T).T + m[:3, 3]
    if inside:
        o = to_world(local(0.6, 0.0))
    else:
        around = torch.randn((n, 3), generator=gen, dtype=torch.float64)
        o = to_world(1.5 * around / around.norm(dim=-1, keepdim=True))
    d = to_world(local(1.0, 0.0)) - o
    d = d / d.norm(dim=-1, keepdim=True)
    return o.float(), d.float()


def _hits(st, cfg, o, d, src=None):
    R0 = o.shape[0]
    t_min = torch.full((R0,), cfg.epsilon)
    src = torch.full((R0,), -1, dtype=torch.int32) if src is None else src
    hit = I.intersect_scene(o, d, t_min, float("inf"), st, cfg, src_node=src,
                            src_tri=torch.full_like(src, -1))
    det = I.hit_detail(o, d, hit, st, cfg, t_min, src_node=src,
                       src_tri=torch.full_like(src, -1))
    return hit, det, t_min


def _reference_surface(sc, o, d, hit, t_min, src=None):
    R0 = o.shape[0]
    src = torch.full((R0,), -1, dtype=torch.int64) if src is None else src.long()
    rays = Rays(o, d, torch.ones(R0), torch.arange(R0), t_min, src, torch.arange(R0),
                torch.zeros((R0, 2), dtype=torch.int64))
    return R.surface(sc, rays, hit.node.long(), hit.t)


@pytest.mark.parametrize("node,kind", [(0, "plane"), (1, "cube")])
def test_uv_and_tangent_frames_match_hit_detail(node, kind):
    """The reference's uv, tangent frame and world normal of the wall
    plane and the table cube against the program's hit_detail."""
    st, sc, cfg = _tables()
    gen = torch.Generator().manual_seed(11 + node)
    o, d = _rays_at(sc, node, 4096, gen)
    hit, det, t_min = _hits(st, cfg, o, d)
    on = hit.hit & (hit.node == node)
    assert int(on.sum()) > 1000
    point, n, uv, frame, has_uv = _reference_surface(sc, o, d, hit, t_min)
    assert bool(has_uv[on].all()) and bool(det.has_uv[on].all())
    torch.testing.assert_close(uv[on], det.uv[on], rtol=0, atol=1e-6)
    torch.testing.assert_close(frame[on], det.nmt[on], rtol=0, atol=1e-6)
    torch.testing.assert_close(n[on], torch.nn.functional.normalize(det.normal[on], dim=-1),
                               rtol=0, atol=1e-6)
    torch.testing.assert_close(point[on], det.point[on], rtol=0, atol=1e-5)
    if kind == "cube":  # every face of the table is seen
        assert len({tuple(v) for v in det.normal[on].sign().int().tolist()}) == 6


@pytest.mark.parametrize("inside", [False, True], ids=["entering", "exiting"])
def test_dielectric_children_match_shade_pre(inside):
    """Refracted directions and the reflected and refracted shares (Schlick,
    and total internal reflection from inside) of the reference against
    the program's shade_pre, on seeded hits on the water."""
    st, sc, cfg = _tables()
    water = 2
    gen = torch.Generator().manual_seed(5 + inside)
    o, d = _rays_at(sc, water, 4096, gen, inside=inside)
    src = torch.full((o.shape[0],), water if inside else -1, dtype=torch.int32)
    hit, det, t_min = _hits(st, cfg, o, d, src=src if inside else None)
    on = hit.hit & (hit.node == water)
    assert int(on.sum()) > 1000
    key = torch.tensor([0, 7], dtype=torch.int64)
    _, ch = S.shade_pre(d, hit, det, st, cfg, key, on)
    _, n, _, _, _ = _reference_surface(sc, o, d, hit, t_min, src)
    mat = sc.node_material[hit.node.long().clamp(min=0)]
    t_dir, reflected, refracted = R.shares(d, n, sc.mat["reflectivity"][mat],
                                           sc.mat["refraction_index"][mat])
    torch.testing.assert_close(reflected[on], ch.refl_mult[on], rtol=0, atol=1e-6)
    torch.testing.assert_close(refracted[on], ch.refr_mult[on], rtol=0, atol=1e-6)
    split = on & (refracted > 0.0)
    torch.testing.assert_close(R.unit(t_dir[split]), ch.refr_dir[split], rtol=0, atol=1e-6)
    tir = on & (refracted == 0.0)
    dn = (d * n).sum(-1)
    if inside:
        assert int(tir.sum()) > 100 and bool((dn[on] > 0).all())
        torch.testing.assert_close(ch.refl_mult[tir], torch.full_like(ch.refl_mult[tir], 0.9))
    else:
        assert int(tir.sum()) == 0 and bool((dn[on] < 0).all())


def test_atlas_sampling_wraps_negative_uv():
    """sample_atlas and the reference's sample pick the same texel for uv
    far outside [0, 1], x = trunc(u (w - 1)) mod w with the euclidean
    remainder: u = -0.5 on a 7-texel row reads texel 4."""
    gen = torch.Generator().manual_seed(3)
    img = torch.randint(0, 256, (5, 7, 3), dtype=torch.uint8, generator=gen)
    data, meta = img.reshape(-1, 3), torch.tensor([[0, 7, 5]], dtype=torch.int32)
    uv = (torch.rand((2048, 2), generator=gen) - 0.5) * 6.0
    ix = torch.zeros(uv.shape[0], dtype=torch.int32)
    for srgb in (True, False):
        torch.testing.assert_close(R.sample(img, uv, srgb),
                                   S.sample_atlas(data, meta, ix, uv, srgb), rtol=0, atol=0)
    texel = S.sample_atlas(data, meta, ix[:1], torch.tensor([[-0.5, -0.5]]), srgb=False)
    torch.testing.assert_close(texel[0], img[3, 4].float() / 255.0)


def _cached(lookup):
    """family.lookup returning one Family per configuration name, so that a
    fault planted in its builder reaches the run."""
    found = {}

    def cached(data):
        return found.setdefault(data.get("scene"), lookup(data))

    return cached


def _in_the_builder(edit):
    """A fault planted in the family's builder: it builds the program's
    scene from a copy of the configuration that `edit` changed."""
    def plant(monkeypatch, data):
        builder = family.lookup(data).builder
        build = builder.build

        def wrong(T_, d):
            d = copy.deepcopy(d)
            edit(d)
            return build(T_, d)

        monkeypatch.setattr(builder, "build", wrong)

    return plant


def _water_ior(d):
    d["materials"][2]["refraction_index"] = 1.5


def _no_normal_maps(d):
    for m in d["materials"]:
        m.pop("normals", None)


def _refract_sid_swapped(monkeypatch, data):
    """The reflected child takes 2 sid + 1 and the refracted one 2 sid."""
    shade = tr._round_shade

    def wrong(*a, **k):
        acc, child, shadow = shade(*a, **k)
        if child is not None:
            half = child.sid.shape[0] // 2
            sid = torch.cat([child.sid[:half] + 1, child.sid[half:] - 1])
            child = child._replace(sid=sid)
        return acc, child, shadow

    monkeypatch.setattr(tr, "_round_shade", wrong)


FAULTS = {"ior_changed": _in_the_builder(_water_ior),
          "normal_map_dropped": _in_the_builder(_no_normal_maps),
          "refract_sid_swapped": _refract_sid_swapped}


@pytest.mark.parametrize("fault", FAULTS)
def test_a_planted_fault_is_not_correct(fault, monkeypatch):
    _, data, traffic, limits = small_cell(CELL, size=(96, 54))
    monkeypatch.setattr(family, "lookup", _cached(family.lookup))
    FAULTS[fault](monkeypatch, data)
    rec = run(data, traffic, limits)
    assert not rec["correct"], rec["checks"]

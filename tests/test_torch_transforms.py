"""The port's transforms, learning-rate schedules and OBJ / PLY writers
against the JAX package's, on the CPU.

Transforms are the same numpy code: given generators seeded alike, the
outputs are bit-identical. Schedules: every step, boundaries included,
within rtol 1e-6 (one-cycle also within 1e-6 of its peak: the JAX form
rounds to float32, the port's is double). Writers: byte-identical files.
"""

import numpy as np
import pytest

from stratified_transformer_torch.data import ply
from stratified_transformer_torch.data import transforms
from stratified_transformer_torch.train import schedulers
from stratified_transformer_tpu.data import ply as jax_ply
from stratified_transformer_tpu.data import transforms as jax_transforms
from stratified_transformer_tpu.train import schedulers as jax_schedulers

SEEDS = range(8)

# (class name, constructor kwargs): the eight the port took over
TRANSFORMS = [
    ("RandomShift", {}),
    ("RandomShift", {"shift_range": 0.5}),
    ("RandomHorizontalFlip", {}),
    ("RandomHorizontalFlip", {"upright_axis": "X"}),
    ("ChromaticAutoContrast", {"p": 0.6}),
    ("ChromaticAutoContrast", {"p": 1.0, "randomize_blend_factor": False,
                               "blend_factor": 0.3}),
    ("ChromaticTranslation", {}),
    ("ChromaticJitter", {"std": 0.05}),
    ("RandomRotatePerturbation", {}),
    ("HueSaturationTranslation", {}),
    ("ElasticDistortion", {}),
    ("ElasticDistortion", {"distortion_params": ((0.1, 0.2),)}),
]


def cloud(seed=0, n=400):
    rng = np.random.default_rng(seed)
    points = rng.uniform(0, 3, (n, 3))
    color = rng.uniform(0, 255, (n, 3))
    color[:5] = [[10, 10, 10], [255, 0, 0], [0, 255, 0], [0, 0, 255],
                 [40, 40, 200]]                 # grey and pure hues
    return points, color


@pytest.mark.parametrize("name,kw", TRANSFORMS,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(TRANSFORMS)])
def test_transform_matches_jax(name, kw):
    points, color = cloud()
    ours = getattr(transforms, name)(**kw)
    theirs = getattr(jax_transforms, name)(**kw)
    for seed in SEEDS:
        p1, c1 = ours(points, color, np.random.default_rng(seed))
        p2, c2 = theirs(points, color, np.random.default_rng(seed))
        assert np.array_equal(p1, p2) and np.array_equal(c1, c2), seed
    assert np.array_equal(points, cloud()[0])   # inputs left as they were


def compose(module):
    return module.Compose([
        module.RandomRotatePerturbation(), module.RandomHorizontalFlip(),
        module.ChromaticAutoContrast(), module.ChromaticTranslation(),
        module.ChromaticJitter(), module.HueSaturationTranslation(),
        module.ElasticDistortion(), module.RandomShift()])


def test_compose_matches_jax_with_and_without_a_generator(monkeypatch):
    points, color = cloud(seed=1)
    for seed in SEEDS:
        got = compose(transforms)(points, color, np.random.default_rng(seed))
        want = compose(jax_transforms)(points, color,
                                       np.random.default_rng(seed))
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
    # without one each draws a fresh generator; make the fresh ones alike
    default_rng = np.random.default_rng
    monkeypatch.setattr(np.random, "default_rng",
                        lambda seed=None: default_rng(7 if seed is None
                                                      else seed))
    got = compose(transforms)(points, color)
    want = compose(jax_transforms)(points, color)
    seeded = compose(transforms)(points, color, default_rng(7))
    assert all(np.array_equal(a, b) and np.array_equal(a, c)
               for a, b, c in zip(got, want, seeded))


def test_compose_draws_a_fresh_generator():
    points, color = cloud(seed=2)
    one = compose(transforms)(points, color)
    two = compose(transforms)(points, color)
    assert not np.array_equal(one[0], two[0])


# (name, args, kwargs, last step); the last step is the schedule's end
SCHEDULES = [
    ("poly_with_warmup", (0.01, 300), {"warmup_iters": 40,
                                       "warmup_ratio": 1e-3}, 300),
    ("poly_with_warmup", (0.006, 120), {"power": 0.9}, 120),
    ("squared", (0.5, 200), {}, 200),
    ("exponential", (0.1, 7), {"gamma": 0.8}, 250),
    ("step_lr", (0.1, 30), {}, 200),
    ("step_lr", (0.02, 4), {"gamma": 0.5}, 60),
    ("one_cycle", (0.01, 100), {}, 100),
    ("one_cycle", (0.05, 337), {"pct_start": 0.25, "div_factor": 10.0},
     337),
]


@pytest.mark.parametrize("name,args,kw,last", SCHEDULES,
                         ids=[f"{s[0]}-{i}" for i, s in
                              enumerate(SCHEDULES)])
def test_schedule_matches_jax(name, args, kw, last):
    ours = getattr(schedulers, name)(*args, **kw)
    theirs = getattr(jax_schedulers, name)(*args, **kw)
    got = np.array([ours(s) for s in range(last + 1)])
    want = np.array([float(theirs(s)) for s in range(last + 1)])
    assert all(isinstance(ours(s), float) for s in (0, last))
    atol = 1e-6 * args[0] if name == "one_cycle" else 0.0
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=atol)


def test_one_cycle_shape():
    f = schedulers.one_cycle(0.01, 100)
    assert f(0) == pytest.approx(0.01 / 25)
    assert f(30) == pytest.approx(0.01)
    assert f(100) == pytest.approx(0.01 / 25 / 1e4)
    assert f(101) == f(100)


def writer_inputs():
    rng = np.random.default_rng(3)
    xyz = rng.uniform(-2, 2, (40, 3)).astype(np.float32)
    labels = rng.integers(0, 60, 40)
    colors = rng.uniform(0, 1, (40, 3))
    return xyz, labels, colors


WRITERS = {
    "save_obj": lambda m, p, xyz, lab, col: m.save_obj(p, xyz),
    "save_obj_colors": lambda m, p, xyz, lab, col: m.save_obj(p, xyz, col),
    "save_obj_color_coding":
        lambda m, p, xyz, lab, col: m.save_obj_color_coding(p, xyz, lab),
    "save_obj_line":
        lambda m, p, xyz, lab, col: m.save_obj_line(p, xyz[:20], xyz[20:]),
    "save_colored_by_label_obj":
        lambda m, p, xyz, lab, col: m.save_colored_by_label(p, xyz, lab,
                                                            fmt="obj"),
    "save_colored_by_label_ply":
        lambda m, p, xyz, lab, col: m.save_colored_by_label(p, xyz, lab),
    "write_ply_points_ascii":
        lambda m, p, xyz, lab, col: m.write_ply_points(
            p, xyz, (col * 255).astype(np.uint8), binary=False),
}


@pytest.mark.parametrize("name", list(WRITERS))
def test_writer_matches_jax_byte_for_byte(name, tmp_path):
    xyz, labels, colors = writer_inputs()
    ours, theirs = tmp_path / "port", tmp_path / "jax"
    WRITERS[name](ply, str(ours), xyz, labels, colors)
    WRITERS[name](jax_ply, str(theirs), xyz, labels, colors)
    assert ours.read_bytes() == theirs.read_bytes()
    assert ours.stat().st_size > 0


def test_cuboid_color_map_is_the_jax_packages():
    assert ply.CUBOID_COLOR_MAP == jax_ply.CUBOID_COLOR_MAP
    assert len(ply.CUBOID_COLOR_MAP) == 29

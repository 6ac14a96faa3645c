"""The port's entry points on the CPU: the command line against the JAX
package's, the named cases, checkpoints and resume, the golden runner, and
the ROADMAP.md items the port's NotImplementedError messages name.

- the same argv parsed by both CLIs gives equal RunConfig fields (all but
  the JAX package's `use_pallas` and the port's `device` and `poly_bf16`,
  which the JAX package has on its SolverConfig only);
- `models.CASES`, `DEFAULT_METHOD` and `get_case` equal the JAX package's;
- a short `-d cpu` run of the port's CLI prints the JAX CLI's final mass
  and max u lines, and a mass loss within 1e-12;
- a run checkpointed at step 3 and resumed ends at the uninterrupted run's
  state (final mass and max u 1e-14 relative); the JAX package's
  `load_state` reads the port's file; a path that is not `.npz` raises;
- `run_goldens --device cpu --only transport-cube-m3pa` exits 0 and lists
  the 15 rows whose reference mesh file is absent (38 of 53 run), each as
  "needs <name>.mesh, absent";
- every "Queue N, item M" in the port's sources is an open item of
  ROADMAP.md's Queue 1 or 2.
"""

import dataclasses
import json
import re
from pathlib import Path

import numpy as np
import pytest

import remhos_tpu.driver as jdriver
from remhos_tpu import checkpoint as jckpt
from remhos_tpu import cli as jcli
from remhos_tpu import models as jmodels

from remhos_torch import checkpoint, cli, driver, models
from remhos_torch.config import RunConfig
from remhos_torch.tools import run_goldens
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]

ARGVS = [
    [],
    ["-m", "periodic-square", "-p", "5", "-rs", "3", "-dt", "0.004", "-tf",
     "0.8", "-ho", "2", "-lo", "3", "-fct", "2", "-pa"],
    ["-m", "inline-quad", "-p", "14", "-rs", "1", "-o", "2", "-mo", "3",
     "-s", "13", "-ps", "-vb", "-um", "-dtc", "1", "-ms", "7", "-fp32",
     "-vs", "5", "-bt", "1", "-si", "2", "-mono", "1"],
    ["-dim", "2", "-epm", "16", "-rp", "1", "-no-pa", "-no-ps", "-no-vb",
     "-chk", "ck.npz", "-chks", "10", "-resume", "-shards", "2", "-dcn",
     "-vis", "-save", "-visit", "-prof", "prof", "-no-vis", "-no-visit"],
]


@pytest.mark.parametrize("argv", ARGVS)
def test_cli_parses_like_jax(argv, monkeypatch):
    got = []
    monkeypatch.setattr(jdriver, "run", got.append)
    assert jcli.main(argv) == 0
    want = dataclasses.asdict(got[0])
    mine = dataclasses.asdict(cli.config_from_args(
        cli.build_parser().parse_args(argv)))
    assert mine.pop("device") is None and want.pop("use_pallas") is False
    assert mine.pop("poly_bf16") is False
    assert mine == want


def test_cli_device_flag():
    parse = cli.build_parser().parse_args
    assert cli.config_from_args(parse(["-d", "cpu"])).device == "cpu"
    assert cli.config_from_args(parse(["-d", "cuda"])).device == "cuda"
    assert cli.config_from_args(parse([])).device is None


def test_cases_equal_jax():
    assert models.CASES == jmodels.CASES
    assert models.DEFAULT_METHOD == jmodels.DEFAULT_METHOD
    for name in models.CASES:
        mine = dataclasses.asdict(models.get_case(name, max_tsteps=3))
        want = dataclasses.asdict(jmodels.get_case(name, max_tsteps=3))
        assert mine.pop("device") is None and want.pop("use_pallas") is False
        assert mine.pop("poly_bf16") is False
        assert mine == want
    assert models.get_case("remap-pacman", device="cpu").device == "cpu"
    with pytest.raises(KeyError):
        models.get_case("no-such-case")


def _final_lines(text):
    out = {}
    for line in text.splitlines():
        for key in ("Final mass u:", "Max value u:", "Mass loss u:"):
            if line.startswith(key):
                out[key] = float(line.split(":")[1])
    return out


def test_cli_run_prints_the_jax_lines(capsys):
    argv = ["-m", "periodic-square", "-p", "5", "-rs", "1", "-dt", "0.004",
            "-tf", "0.02", "-ho", "2", "-lo", "3", "-fct", "2", "-pa"]
    assert jcli.main(argv) == 0
    want = _final_lines(capsys.readouterr().out)
    assert cli.main(argv + ["-d", "cpu"]) == 0
    got = _final_lines(capsys.readouterr().out)
    assert len(got) == len(want) == 3
    for key in ("Final mass u:", "Max value u:"):
        assert abs(got[key] - want[key]) <= 1e-12 * abs(want[key])
    assert abs(got["Mass loss u:"] - want["Mass loss u:"]) <= 1e-12


RESUMED = dict(mesh="periodic-square", problem=5, rs_levels=1, dt=0.004,
               t_final=0.04, ho=3, lo=5, fct=2, pa=True, verbose=False,
               device="cpu")


def test_checkpoint_and_resume(tmp_path):
    path = str(tmp_path / "ck.npz")
    whole = driver.run(RunConfig(**RESUMED))
    part = driver.run(RunConfig(**RESUMED, checkpoint_path=path,
                                checkpoint_steps=3, max_tsteps=3))
    assert part.steps == 3
    S, t, dt, ti = jckpt.load_state(path)
    assert (S.shape[0], ti, dt) == (1, 3, RESUMED["dt"])
    assert t == pytest.approx(3 * RESUMED["dt"], rel=1e-15)
    S2, t2, dt2, ti2 = checkpoint.load_state(path)
    assert np.array_equal(S, S2) and (t, dt, ti) == (t2, dt2, ti2)
    rest = driver.run(RunConfig(**RESUMED, checkpoint_path=path,
                                resume=True))
    assert rest.steps == whole.steps and rest.t == pytest.approx(whole.t)
    assert abs(rest.final_mass_u - whole.final_mass_u) <= \
        1e-14 * whole.final_mass_u
    assert abs(rest.max_u - whole.max_u) <= 1e-14 * whole.max_u


def test_checkpoint_path_must_be_npz(tmp_path):
    with pytest.raises(ValueError, match="npz"):
        checkpoint.save_state(str(tmp_path / "ck"), np.zeros((1, 2, 4)),
                              0.0, 0.1, 0)
    with pytest.raises(ValueError, match="npz"):
        driver.run(RunConfig(**RESUMED, checkpoint_path=str(tmp_path / "d"),
                             resume=True))


def test_run_goldens_lists_the_rest(capsys):
    assert run_goldens.main(["--device", "cpu", "--only",
                             "transport-cube-m3pa"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["matched"] == ["transport-cube-m3pa"] and not rec["failed"]
    rows = json.loads(run_goldens.GOLDENS.read_text())["runs"]
    assert len(rows) == 53 and len(rec["absent"]) == 15
    supported = {r["name"] for r in rows} - set(rec["absent"])
    kinds = ("remap-cube3d", "remap-pacman", "transport-ballsjacks",
             "transport-cube")
    fa = {f"{kind}-m{m}" for kind in kinds for m in (1, 2, 5)} | {
        "product-remap-fe-fct",
        "product-remap-idp2", "product-remap-idp3", "sharpen-pacman-autodt",
        "sharpen-ballsjacks-autodt"} | {
        f"readme-run{k}-{m}" for k, m in ((5, "ballsjacks"),
                                          (6, "ballsjacks"), (7, "cube"),
                                          (9, "pacman"), (10, "product"),
                                          (11, "cube3d"))}
    pa = {f"{kind}-m{lo}pa" for lo in (3, 4) for kind in kinds}
    mono_1d = {"steady-mono1", "steady-mono2"} | {
        f"transport-1d-m{m}" for m in range(1, 6)}
    assert len(fa) == 23 and supported == fa | pa | mono_1d
    assert len(supported) == 38
    meshes = {r["name"]: r["cfg"]["mesh"] for r in rows}
    for name, why in rec["absent"].items():
        assert why == f"needs {meshes[name]}.mesh, absent"
        assert meshes[name] in ("periodic-hexagon", "disc-nurbs",
                                "ball-nurbs")


def _open_items(roadmap):
    """{queue: {item numbers not struck through}} of ROADMAP.md."""
    items, queue = {}, None
    for line in roadmap.splitlines():
        m = re.match(r"### Queue (\d)", line)
        if m:
            queue = int(m.group(1))
            items[queue] = set()
        elif line.startswith("## "):
            queue = None
        elif queue is not None:
            m = re.match(r"(\d+)\. (.*)", line)
            if m and not m.group(2).startswith("~~"):
                items[queue].add(int(m.group(1)))
    return items


def test_unported_messages_name_open_roadmap_items():
    items = _open_items((ROOT / "ROADMAP.md").read_text())
    named = set()
    for f in (ROOT / "remhos_torch").rglob("*.py"):
        for q, i in re.findall(r"Queue (\d), item (\d+)", f.read_text()):
            named.add((int(q), int(i)))
    # every item an unported message names is open, and every open item
    # of Queues 1 and 2 has such a message: after PR 13 none is left
    for q, i in sorted(named):
        assert q in (1, 2) and i in items[q], (q, i)
    assert named == {(q, i) for q in (1, 2) for i in items[q]}

"""The port's CLI under torch's launcher environment: ``fit``,
``validate`` and a resumed ``fit`` of the tiny Refign-HRDA config
(``tests/test_torch_data.py:tiny_hrda_config`` at batch 2 + 2, no loader
workers) on 2 gloo ranks on the CPU, each rank a process that sets
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT`` and calls ``cli.main`` (``tests/torch_dist_ranks.py:
cli_case``), against ``cli.main`` in one process.

* the fit writes one set of files (rank 0's): metrics.jsonl's lines once,
  timing.jsonl with every rank's loader wait, one checkpoint; its
  checkpoint matches the single process's at 1e-5 of each group's largest
  entry;
* ``validate`` from that checkpoint (the 30-odd slide rows of each image
  spread over the ranks) gives the single process's confusion matrices
  exactly, on both ranks;
* a resumed fit takes both ranks in step (their students equal);
* a world size that does not divide the batch raises, naming the largest
  that does;
* ``entry.dryrun_multigpu(2, 'cpu')`` runs its Refign-HRDA step on 2 gloo
  ranks and finds the loss finite and the parameters equal.
"""
import json
import os

import numpy as np
import pytest
import torch
import yaml

import torch_dist_ranks as R
from refign_tpu_torch.data.synthetic import make_acdc, make_cityscapes
from refign_tpu_torch.entry import dryrun_multigpu
from test_torch_data import tiny_hrda_config


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("dist_cli")
    data = str(root / "data")
    make_cityscapes(os.path.join(data, "Cityscapes"))
    make_acdc(os.path.join(data, "ACDC"))
    cfgs = {}
    for name, bs in (("cfg", 4), ("odd", 2)):
        path = str(root / f"{name}.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(tiny_hrda_config(batch_size=bs), f,
                           sort_keys=False)
        cfgs[name] = path

    def common(wd, cfg="cfg"):
        return ["--config", cfgs[cfg], "--data_dir", data, "--workdir", wd,
                "--device", "cpu"]
    dist_wd, single_wd = str(root / "dist"), str(root / "single")
    last = os.path.join(dist_wd, "checkpoints", "last")
    calls = [(["fit"] + common(dist_wd), R.free_port()),
             (["validate", "--ckpt_path", last] + common(dist_wd),
              R.free_port()),
             (["fit", "--ckpt_path", last, "--trainer.max_steps", "3",
               "--trainer.val_every_n_steps", "10"] + common(dist_wd),
              R.free_port()),
             (["fit"] + common(str(root / "odd"), "odd"), R.free_port())]
    ranks = R.spawn(R.cli_case, 2, str(root / "ranks"), calls, join=False)
    # the same fit in one process (no group)
    single = R.cli_case(0, 1, [(["fit"] + common(single_wd), 0)])
    return dict(ranks=ranks, single=single[0], dist_wd=dist_wd,
                single_wd=single_wd)


def _lines(path):
    with open(path) as f:
        return [json.loads(l) for l in f]


def test_fit_writes_rank_zero_files_once(run):
    lines = _lines(os.path.join(run["dist_wd"], "metrics.jsonl"))
    # the fit's steps 1, 2, its validation, then the resumed step 3
    assert [l["step"] for l in lines] == [1, 2, 2, 3, 3]
    timing = _lines(os.path.join(run["dist_wd"], "timing.jsonl"))
    assert [t["step"] for t in timing] == [1, 2, 3]
    assert all(len(t["data_wait_s_ranks"]) == 2 for t in timing)
    ckpts = sorted(os.listdir(os.path.join(run["dist_wd"], "checkpoints")))
    assert ckpts == ["last", "step_2.pt", "step_3.pt"]
    single = _lines(os.path.join(run["single_wd"], "metrics.jsonl"))
    for got, want in zip(lines[:3], single):
        assert got.keys() == want.keys()
        for k in want:
            if k != "sps":
                np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                           err_msg=k)


def test_fit_checkpoint_matches_one_process(run):
    got = torch.load(os.path.join(run["dist_wd"], "checkpoints",
                                  "step_2.pt"), weights_only=True)
    want = torch.load(os.path.join(run["single_wd"], "checkpoints",
                                   "step_2.pt"), weights_only=True)
    for part in ("student", "teacher"):
        g, w = got[part], want[part]
        scale = {}
        for k, v in w.items():
            if v.is_floating_point():
                grp = k.split(".")[0]
                scale[grp] = max(scale.get(grp, 0.0), float(v.abs().max()))
        for k, v in w.items():
            if not v.is_floating_point():
                assert torch.equal(g[k], v), k
                continue
            err = float((g[k] - v).abs().max())
            assert err <= 1e-5 * scale[k.split(".")[0]], (part, k)


def test_validate_gives_the_single_process_confusion_matrices(run):
    want = run["single"]["confmats"][-1]
    assert any(int(c.sum()) > 0 for m in want.values() for c in m.values())
    for rank in run["ranks"]:
        fit, validate = rank[0], rank[1]
        for got in (fit["confmats"][-1], validate["confmats"][-1]):
            assert got.keys() == want.keys()
            for name, m in want.items():
                for ig, c in m.items():
                    assert torch.equal(got[name][ig], c), (name, ig)


def test_resume_keeps_the_ranks_in_step(run):
    a, b = (r[2]["student"] for r in run["ranks"])
    assert a is not None
    for k, v in a.items():
        assert torch.equal(v, b[k]), k


def test_world_size_that_does_not_divide_the_batch_raises(run):
    for rank in run["ranks"]:
        err = rank[3]["error"]
        assert err is not None and "world size 2 does not divide" in err
        assert "the largest world size that divides them all is 1" in err


def test_dryrun_multigpu_on_two_gloo_ranks(capfd):
    dryrun_multigpu(2, "cpu")
    out = capfd.readouterr().out
    assert "dryrun_multigpu(2) on cpu: train step ok" in out
    assert "parameters equal on every rank" in out

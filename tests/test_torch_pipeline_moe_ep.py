"""Port parity of the pipeline over the MoE LM, its second half (the
helpers and the first half are ``test_torch_pipeline_moe.py``, whose
docstring states the checks): ``moe_every`` 2 under 1f1b and interleaved
on pipe 2 x data 2, pipe 2 x expert 2 (gpipe, and 1f1b with ``moe_every``
2), the expert slices inside the stages, and the checkpoint resumed bit for
bit under the expert split, on a 4-rank gang of this file's own.
"""

import json

import numpy as np
import pytest
import torch

from test_torch_pipeline_moe import (
    E,
    GOLDEN,
    TINY_MOE,
    _flat,
    _key,
    _overrides,
    _params,
    check_eval,
    check_schedule,
    jax_runs_for,
    start_gang,
)

from pytorch_distributed_nn_tpu_torch.train.checkpoint import read_full_params

HERE = ("moe2_1f1b", "moe2_interleaved", "ep_gpipe", "ep_moe2_1f1b")


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    return start_gang(tmp_path_factory, HERE, lambda inits, d: {
        "ckpt_ep": {"ov": _overrides(TINY_MOE, "1f1b", steps=4, pipe=2,
                                     expert=2),
                    "init": inits[_key(TINY_MOE)],
                    "ckpt": str(d / "ckpt")}})


@pytest.fixture(scope="module")
def jax_runs(started):
    return jax_runs_for(HERE)


@pytest.fixture(scope="module")
def gang(started, jax_runs):
    handle, runs, d = started
    return handle.ranks(), runs, d


@pytest.mark.parametrize("against", ["jax_single", "jax_pipeline"])
@pytest.mark.parametrize("name", HERE)
def test_moe_schedule_matches_jax(gang, jax_runs, name, against):
    check_schedule(gang, jax_runs, name, against)


def test_expert_leaves_split_over_expert_inside_the_stages(gang, jax_runs):
    """pipe 2 x expert 2: rank (d, e) holds experts [2e, 2e + 2) of the MoE
    layers of stage d's blocks only, and they are the JAX run's slices."""
    ranks, _, _ = gang
    singles, _ = jax_runs
    final = _flat(singles[_key(TINY_MOE)][2])
    for name in ("ep_gpipe", "ep_moe2_1f1b"):
        extra = GOLDEN[name][0]
        e = extra["moe_every"]
        for r in ranks:
            d, ex = (int(v) for v in r[f"{name}/coords"])
            held = sorted(k.split("/")[2].split(".")[0] for k in r
                          if k.startswith(f"{name}/param/")
                          and k.endswith(".moe.wi"))
            assert held == [f"block{i}" for i in (2 * d, 2 * d + 1)
                            if i % e == e - 1]
            for blk in held:
                wi = r[f"{name}/param/{blk}.moe.wi"]
                assert wi.shape == (E // 2, 32, 64)
                if name == "ep_gpipe":
                    want = final[f"{blk}.moe.wi"][2 * ex:2 * ex + 2]
                    np.testing.assert_allclose(
                        wi, want, rtol=0, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("name", HERE)
def test_moe_pipeline_eval_matches_jax_and_leaves_the_aux_out(gang, jax_runs,
                                                             name):
    check_eval(gang, jax_runs, name)


def test_resume_bit_for_bit_and_full_read_under_the_expert_split(gang):
    ranks, _, d = gang
    parts = sorted(str(r["ckpt_ep/part"]) for r in ranks)
    assert parts == ["pipe0-expert0", "pipe0-expert1", "pipe1-expert0",
                     "pipe1-expert1"]
    for r in ranks:
        flags = r["ckpt_ep/resume"]
        assert flags[0] == 2 and flags[1:].all()
        np.testing.assert_array_equal(r["ckpt_ep/resumed_losses"],
                                      r["ckpt_ep/losses"][2:])
    full = read_full_params(d / "ckpt" / "straight")
    want = _params(ranks, "ckpt_ep", expert=2)
    assert sorted(full) == sorted(want)
    assert full["block0.moe.wi"].shape[0] == E
    for k, v in full.items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
    meta = json.loads(next((d / "ckpt" / "straight").glob("4/meta.json"))
                      .read_text())
    assert sorted(meta["layout"]["experts"]) == sorted(
        f"block{i}.moe.{w}" for i in range(4) for w in ("wi", "wo"))
    assert torch.equal(full["block3.moe.wo"],
                       torch.from_numpy(want["block3.moe.wo"]))

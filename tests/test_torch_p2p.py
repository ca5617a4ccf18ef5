"""The point-to-point batches of ``ops/collectives.py`` on 4 gloo ranks:
the ring's ``shift_right`` and the pipeline's ``exchange`` each post
several messages of one size to one peer in one ``batch_isend_irecv``.
Every message carries its place in the batch as its tag (counted per peer,
sends and receives apart), so a receive can only take its own message.

One ``torchrun`` gang (a free port, a nonce, a hard timeout, as
``tests/test_torch_sequence.py`` runs its gang) checks, over many rounds
with each rank delayed at random before it posts:

- the tags every batch posts: 0 .. n - 1 to each peer, in order;
- that each of four same-sized tensors of a ``shift_right`` reaches the
  output of its own place on the next rank, and its gradient (the shift
  back) the input of its own place;
- that ``exchange`` with three same-sized sends to one peer, and a rank
  that sends to and receives from the same peer in one batch (the 1f1b
  hop), fills each receive with the message of its own place.
"""

import json
import subprocess
import sys
import uuid
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
TIMEOUT = 120
WORLD = 4
ROUNDS = 40

_WORKER = r"""
import json, random, sys, time
import numpy as np
import torch
import torch.distributed as dist
from pytorch_distributed_nn_tpu_torch.ops import collectives as cc
from pytorch_distributed_nn_tpu_torch.runtime import bootstrap

out_dir, nonce, rounds = sys.argv[1], sys.argv[2], int(sys.argv[3])
proc = bootstrap.initialize("cpu")
r, n = proc.rank, proc.world_size
ranks = [None] * n
dist.all_gather_object(ranks, (r, nonce))
posted = []  # (op, peer, tag) of every P2POp built
_P2POp = dist.P2POp


def recording_op(op, tensor, peer, group=None, tag=0):
    posted.append(("send" if op is dist.isend else "recv", peer, tag))
    return _P2POp(op, tensor, peer, group=group, tag=tag)


dist.P2POp = recording_op
rng = random.Random(1000 + r)


def payload(src, j, k):  # what rank src sends as message j in round k
    return torch.full((64,), float(src * 1000 + j * 100 + k))


bad = []
for k in range(rounds):
    time.sleep(rng.random() * 0.004)
    xs = [payload(r, j, k).requires_grad_() for j in range(4)]
    outs = cc.shift_right(xs, dist.group.WORLD, n)
    src = (r - 1) % n
    for j, o in enumerate(outs):
        if not torch.equal(o.detach(), payload(src, j, k)):
            bad.append(f"shift round {k} place {j}: got {o[0].item()}")
    sum(((j + 1) * o).sum() for j, o in enumerate(outs)).backward()
    for j, x in enumerate(xs):
        if not torch.equal(x.grad, torch.full((64,), float(j + 1))):
            bad.append(f"shift back round {k} place {j}: got "
                       f"{x.grad[0].item()}")
    time.sleep(rng.random() * 0.004)
    # ranks 0 and 1 swap three messages each way in one batch; ranks 2
    # and 3 send three to their right neighbour in the pair
    if r < 2:
        peer = 1 - r
        sends = [(peer, payload(r, j, k)) for j in range(3)]
        recvs = [(peer, torch.empty(64)) for _ in range(3)]
    elif r == 2:
        sends, recvs = [(3, payload(r, j, k)) for j in range(3)], []
    else:
        sends, recvs = [], [(2, torch.empty(64)) for _ in range(3)]
    cc.exchange(sends, recvs, dist.group.WORLD)
    for j, (peer, t) in enumerate(recvs):
        if not torch.equal(t, payload(peer, j, k)):
            bad.append(f"exchange round {k} place {j}: got {t[0].item()}")
res = {"nonce": nonce, "world": n, "gang": json.dumps(ranks), "bad": bad,
       "posted": posted}
with open(f"{out_dir}/rank{r}.json", "w") as f:
    json.dump(res, f)
bootstrap.shutdown()
"""


def _env():
    from test_torch_sequence import _env as sequence_env

    return sequence_env()


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    d = tmp_path_factory.mktemp("p2p_gang")
    script = d / "worker.py"
    script.write_text(_WORKER)
    nonce = uuid.uuid4().hex
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(WORLD), str(script), str(d), nonce,
           str(ROUNDS)]
    out = subprocess.run(cmd, cwd=ROOT, env=_env(), capture_output=True,
                         text=True, timeout=TIMEOUT)
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-4000:])
    ranks = [json.loads((d / f"rank{r}.json").read_text())
             for r in range(WORLD)]
    want = [[r, nonce] for r in range(WORLD)]
    for r in ranks:
        assert r["nonce"] == nonce and r["world"] == WORLD
        assert json.loads(r["gang"]) == want
    return ranks


def test_each_message_reaches_its_own_place(gang):
    for rank, res in enumerate(gang):
        assert not res["bad"], (rank, res["bad"][:8])


@pytest.mark.parametrize("rank", range(WORLD))
def test_batches_tag_each_message_by_its_place(gang, rank):
    """A shift posts 4 sends to the next rank and 4 receives from the one
    before, tags 0-3 (its backward likewise, the other way); an exchange
    tags its messages to each peer 0, 1, 2."""
    posted = [tuple(p) for p in gang[rank]["posted"]]
    nxt, prv = (rank + 1) % WORLD, (rank - 1) % WORLD
    shift = ([("send", nxt, j) for j in range(4)]
             + [("recv", prv, j) for j in range(4)])
    back = ([("send", prv, j) for j in range(4)]
            + [("recv", nxt, j) for j in range(4)])
    if rank < 2:
        hop = ([("send", 1 - rank, j) for j in range(3)]
               + [("recv", 1 - rank, j) for j in range(3)])
    elif rank == 2:
        hop = [("send", 3, j) for j in range(3)]
    else:
        hop = [("recv", 2, j) for j in range(3)]
    assert posted == (shift + back + hop) * ROUNDS, posted[:24]


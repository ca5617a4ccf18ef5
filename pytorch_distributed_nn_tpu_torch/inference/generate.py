"""Autoregressive generation with a KV cache.

Counterpart of the JAX package's ``inference/generate.py``:

- :func:`init_cache` sizes the model's decode cache (``model.init_cache``:
  one dict per attention layer, in the compute dtype or int8 with f32
  scales, plus the transformer LM's ``pos_index``), zeros on the model's
  device;
- the prompt is consumed in ONE prefill forward, or in ``prefill_chunk``
  pieces that each attend to the cache prefix; the cache is updated in
  place by every forward (the JAX code donates it instead);
- the token loop is a Python loop of one-token decode forwards; sampling
  (``temperature``, ``top_k``, ``top_p`` from an ``rng`` key) draws with
  JAX's threefry (``utils/threefry.py``), splitting the key every step as
  the JAX loop does, so a seeded run gives the JAX run's tokens;
- ``eos_token``: a row that emits it keeps it and pads with it.

Ragged batches (``prompt_lengths``) are realigned left and decoded with
per-row cache positions; each row's greedy output equals a solo run of
that row.

``mesh=`` decodes tensor-parallel, as the JAX ``generate(mesh=)``: every
rank of the process group calls it with the same prompt, the model is laid
out in place by the TP rules (``parallel.tensor.shard_for_inference``: the
float leaves cut to the rank's slices, int8 leaves whole) and the KV cache
holds the rank's key/value heads where ``tensor`` divides them. Every rank
gets the same logits (the head's slices gathered), so the same tokens.
Ragged prompts with a mesh raise, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from pytorch_distributed_nn_tpu_torch.utils import threefry

def process_mesh_of(mesh):
    """``mesh`` as this rank's ``ProcessMesh``: one as it is, or a
    ``MeshSpec`` resolved on the process group (every rank calls this)."""
    from pytorch_distributed_nn_tpu_torch.ops import collectives as cc
    from pytorch_distributed_nn_tpu_torch.runtime.mesh import (
        MeshSpec,
        process_mesh,
    )

    if isinstance(mesh, MeshSpec):
        return process_mesh(mesh, cc.rank(), cc.world_size())
    return mesh


def init_cache(model, batch_size: int, max_len: int) -> dict:
    """The model's decode cache for a (batch_size, max_len) stream, zeros
    on its device; raises ValueError for a model with no decode cache."""
    make = getattr(model, "init_cache", None)
    if make is None:
        raise ValueError(f"{type(model).__name__} has no decode cache "
                         "support")
    return make(batch_size, max_len)


def cache_bytes(cache) -> int:
    """Bytes of every tensor in a decode cache."""
    if isinstance(cache, torch.Tensor):
        return cache.numel() * cache.element_size()
    return sum(cache_bytes(v) for v in cache.values())


def _last_real(logits: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """(B, V) logits at each row's last real position (lengths - 1)."""
    rows = torch.arange(logits.shape[0], device=logits.device)
    return logits[rows, lengths.to(torch.int64) - 1]


@torch.inference_mode()
def prefill_ragged(model, cache: dict, tokens: torch.Tensor,
                   lengths: torch.Tensor) -> torch.Tensor:
    """Ragged prefill: ``tokens`` (B, P) LEFT-ALIGNED rows (row i's prompt
    in columns [0, lengths[i])). Every row writes its KV from slot 0 and the
    causal mask keeps slots >= lengths[i] out of every consumed row. Full
    logits are computed (the last real position differs per row); returns
    the (B, V) logits at each row's last real position."""
    zeros = torch.zeros((tokens.shape[0],), dtype=torch.int32,
                        device=tokens.device)
    logits = model(tokens, cache=cache, cache_positions=zeros)
    return _last_real(logits, lengths)


@torch.inference_mode()
def decode_step_ragged(model, cache: dict, tokens: torch.Tensor,
                       positions: torch.Tensor, **extra) -> torch.Tensor:
    """One per-row decode step: ``tokens`` (B,) next tokens, ``positions``
    (B,) per-row cache depths (row i's token lands in slot positions[i]).
    ``extra`` goes to the model (the serving engine's per-row LoRA
    ``lora_bank`` and ``adapter_ids``). Returns (B, V) next-token
    logits."""
    logits = model(tokens[:, None], cache=cache,
                   cache_positions=positions.to(torch.int32),
                   last_only=True, **extra)
    return logits[:, -1, :]


def _sample(logits: torch.Tensor, *, temperature: float, top_k: int,
            top_p: float, key: torch.Tensor) -> torch.Tensor:
    """(B, V) f32 logits -> (B,) tokens, the JAX ``_sample`` with one key
    for the batch: the top-k mask (keep the values >= the k-th largest),
    then the nucleus over what stays (the smallest sorted prefix whose
    mass before a token is below top_p), the logits over max(temperature,
    1e-6), and ``categorical`` (Gumbel noise over every element of the
    (B, V) array)."""
    neg = torch.tensor(float("-inf"), device=logits.device)
    if top_k > 0:
        k = min(top_k, logits.shape[-1])
        kth = torch.topk(logits, k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, neg, logits)
    if top_p > 0.0:
        desc = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(desc, dim=-1)
        keep = torch.cumsum(probs, dim=-1) - probs < top_p
        cutoff = torch.where(keep, desc, -neg).amin(-1, keepdim=True)
        logits = torch.where(logits < cutoff, neg, logits)
    t = torch.tensor(max(np.float32(temperature), np.float32(1e-6)),
                     device=logits.device)
    scaled = logits / t
    return threefry.categorical(key, scaled)


@torch.inference_mode()
def generate(model, prompt, max_new_tokens: int, *,
             temperature: float = 0.0, top_k: int = 0, top_p: float = 0.0,
             rng=None, eos_token: int | None = None, mesh=None,
             prefill_chunk: int = 0, prompt_lengths=None) -> torch.Tensor:
    """Continuations of ``prompt`` (B, P) int; returns (B, P +
    max_new_tokens) int32 tokens on the model's device (prompt included).

    ``temperature`` > 0 samples (``top_k``, ``top_p`` mask first) from
    ``rng``: a (2,) threefry key (``utils.threefry.prng_key``) or an int
    seed; each step splits it into the next key and the step's key, as the
    JAX loop does. With ``eos_token`` set, a row that emits it keeps it and
    then pads with it (the batch still runs max_new_tokens steps).

    ``prefill_chunk``: consume the prompt in chunks of this many tokens,
    each attending to the cache prefix (live scores (chunk, P) instead of
    (P, P)); the same tokens.

    ``prompt_lengths`` (B,): row i's real prompt is the LAST
    prompt_lengths[i] columns (left padding, pad values don't-care).

    ``mesh`` (a ``runtime.mesh.ProcessMesh``, or a ``MeshSpec`` resolved
    on the process group): decode tensor-parallel over its ``tensor``
    axis, the model laid out in place (module docstring)."""
    dev = model.device
    prompt = torch.tensor(np.asarray(prompt), dtype=torch.int32, device=dev)
    if prompt.dim() != 2 or prompt.shape[1] < 1:
        raise ValueError(
            f"prompt must be (B, P>=1), got {tuple(prompt.shape)}")
    if max_new_tokens < 0:
        raise ValueError(
            f"max_new_tokens must be >= 0, got {max_new_tokens}")
    if temperature < 0.0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")
    if not 0.0 <= top_p <= 1.0:
        raise ValueError(f"top_p must be in [0, 1], got {top_p}")
    if prefill_chunk < 0:
        raise ValueError(f"prefill_chunk must be >= 0, got {prefill_chunk}")
    if temperature > 0.0 and rng is None:
        raise ValueError("sampling (temperature > 0) needs an rng key")
    B, P = prompt.shape
    if prompt_lengths is not None:
        lens = np.asarray(prompt_lengths, dtype=np.int64)
        if lens.shape != (B,):
            raise ValueError(
                f"prompt_lengths must be ({B},), got {lens.shape}")
        if lens.min() < 1 or lens.max() > P:
            raise ValueError(f"prompt_lengths must be in [1, {P}], got "
                             f"[{lens.min()}, {lens.max()}]")
        if mesh is not None:
            raise ValueError(
                "ragged prompts (prompt_lengths) are not supported with "
                "mesh sharding: run the uniform path, or batch equal-length "
                "rows")
        if prefill_chunk:
            raise ValueError("prompt_lengths and prefill_chunk are mutually "
                             "exclusive (ragged prefill is one forward)")
    if mesh is not None:
        from pytorch_distributed_nn_tpu_torch.parallel.tensor import (
            shard_for_inference,
        )

        shard_for_inference(model, process_mesh_of(mesh).tensor)
    if max_new_tokens == 0:
        return prompt
    if temperature > 0.0:
        key = (threefry.prng_key(rng, device=dev) if isinstance(rng, int)
               else torch.as_tensor(np.asarray(rng), dtype=torch.int64,
                                    device=dev))
    cache = init_cache(model, B, P + max_new_tokens)
    if prompt_lengths is None:
        # uniform batch: the shared cache_index, last_only prefill
        step = prefill_chunk if 0 < prefill_chunk < P else P
        for start in range(0, P, step):
            logits = model(prompt[:, start:start + step], cache=cache,
                           last_only=True)[:, -1, :]
        pos = None
    else:
        lengths = torch.as_tensor(lens, device=dev)
        # realign: aligned[i, j] = prompt[i, (j + P - L_i) % P]
        shift = (torch.arange(P, device=dev)[None, :]
                 + (P - lengths)[:, None]) % P
        aligned = torch.gather(prompt, 1, shift)
        logits = prefill_ragged(model, cache, aligned, lengths)
        pos = lengths.to(torch.int32)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    out = []
    for step in range(max_new_tokens):
        if temperature > 0.0:
            key, step_key = threefry.split(key)
            tok = _sample(logits, temperature=temperature, top_k=top_k,
                          top_p=top_p, key=step_key)
        else:  # greedy: the JAX loop's key is never read
            tok = torch.argmax(logits, dim=-1)
        if eos_token is not None:
            tok = torch.where(done, eos_token, tok)
            done = done | (tok == eos_token)
        tok = tok.to(torch.int32)
        out.append(tok)
        if step == max_new_tokens - 1:
            break  # the JAX scan's last decode is dead compute
        if pos is None:
            logits = model(tok[:, None], cache=cache, last_only=True)[:, -1]
        else:
            logits = decode_step_ragged(model, cache, tok, pos)
            pos = pos + 1
    return torch.cat([prompt, torch.stack(out, dim=1)], dim=1)

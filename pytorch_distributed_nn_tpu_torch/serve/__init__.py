"""Serving stack: decoding policy, KV pool, scheduler, continuous-batching
engine and the loopback server."""

from pytorch_distributed_nn_tpu_torch.serve.decoding import (
    DecodeSpec,
    TokenStream,
)
from pytorch_distributed_nn_tpu_torch.serve.engine import ServingEngine
from pytorch_distributed_nn_tpu_torch.serve.kv_pool import KVPool
from pytorch_distributed_nn_tpu_torch.serve.scheduler import Request, Scheduler
from pytorch_distributed_nn_tpu_torch.serve.server import (
    InferenceServer,
    arrival_offsets,
    closed_loop_client,
    open_loop_client,
    ragged_prompt_sampler,
    wait_all,
)

__all__ = [
    "DecodeSpec", "InferenceServer", "KVPool", "Request", "Scheduler",
    "ServingEngine", "TokenStream",
    "arrival_offsets", "closed_loop_client", "open_loop_client",
    "ragged_prompt_sampler", "wait_all",
]

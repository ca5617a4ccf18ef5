"""Serving stack: decoding policy, KV pool, prefix cache, scheduler,
continuous-batching engine with per-request LoRA adapters, and the
loopback server."""

from pytorch_distributed_nn_tpu_torch.nn.lora import (
    init_lora_bank,
    merge_lora,
    num_adapters,
)
from pytorch_distributed_nn_tpu_torch.serve.decoding import (
    DecodeSpec,
    TokenStream,
)
from pytorch_distributed_nn_tpu_torch.serve.engine import ServingEngine
from pytorch_distributed_nn_tpu_torch.serve.kv_pool import KVPool
from pytorch_distributed_nn_tpu_torch.serve.prefix_cache import (
    PrefixCache,
    PrefixMatch,
)
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
    "DecodeSpec", "InferenceServer", "KVPool", "PrefixCache", "PrefixMatch",
    "Request", "Scheduler", "ServingEngine", "TokenStream",
    "arrival_offsets", "closed_loop_client", "init_lora_bank", "merge_lora",
    "num_adapters", "open_loop_client", "ragged_prompt_sampler", "wait_all",
]

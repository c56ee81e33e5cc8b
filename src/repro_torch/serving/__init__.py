"""Continuous-batching BNN inference engine over the block-paged KV
cache (the part of the JAX package's ``repro.serving`` that serves
mixed-role fcfs traffic: greedy or sampled decoding with stop tokens,
the prefix cache, swap-to-host or recompute preemption)."""
from repro_torch.serving.block_cache import (                       # noqa: F401
    BlockAllocator, BlockKVCache, MixerStateCache, PrefixIndex, chunk_key)
from repro_torch.serving.cost_model import PhotonicCostModel, gemm_specs  # noqa: F401
from repro_torch.serving.engine import Engine, EngineConfig, nearest_rank  # noqa: F401
from repro_torch.serving.policy import FCFSPolicy, make_policy      # noqa: F401
from repro_torch.serving.request import Request, State              # noqa: F401
from repro_torch.serving.sampling import (                          # noqa: F401
    SamplingParams, SamplingRows, sample_tokens, sampling_rows)
from repro_torch.serving.scheduler import (                         # noqa: F401
    Scheduler, SchedulerConfig, StepPlan)
from repro_torch.serving.tracing import Tracer                      # noqa: F401

"""Continuous-batching BNN inference engine over the block-paged KV
cache (the slice of the JAX package's ``repro.serving`` that serves
greedy, mixed-role, recompute-preemption traffic)."""
from repro_torch.serving.block_cache import (                       # noqa: F401
    BlockAllocator, BlockKVCache, MixerStateCache)
from repro_torch.serving.cost_model import PhotonicCostModel, gemm_specs  # noqa: F401
from repro_torch.serving.engine import Engine, EngineConfig, nearest_rank  # noqa: F401
from repro_torch.serving.policy import FCFSPolicy, make_policy      # noqa: F401
from repro_torch.serving.request import Request, State              # noqa: F401
from repro_torch.serving.sampling import SamplingParams, sample_tokens  # noqa: F401
from repro_torch.serving.scheduler import (                         # noqa: F401
    Scheduler, SchedulerConfig, StepPlan)
from repro_torch.serving.tracing import Tracer                      # noqa: F401

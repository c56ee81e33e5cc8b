"""Continuous-batching BNN inference engine over the block-paged KV
cache, the port of the JAX package's ``repro.serving``: greedy or
sampled decoding with stop tokens, the prefix cache, swap-to-host or
recompute preemption, speculative decoding, the fcfs/priority/slo
policies, teacher-forced scoring, the structured trace with its
photonic replay, the asyncio front-end, worker roles and the sharded
engine (migration, prefill->decode handoff, shard-fault rescue)."""
from repro_torch.serving.block_cache import (                       # noqa: F401
    BlockAllocator, BlockKVCache, MixerStateCache, PrefixIndex, chunk_key)
from repro_torch.serving.cost_model import PhotonicCostModel, gemm_specs  # noqa: F401
from repro_torch.serving.engine import Engine, EngineConfig, nearest_rank  # noqa: F401
from repro_torch.serving.frontend import Frontend                   # noqa: F401
from repro_torch.serving.policy import (                            # noqa: F401
    LATENCY, THROUGHPUT, FCFSPolicy, PriorityPolicy, SLOPolicy,
    SchedulingPolicy, TenantSpec, make_policy, parse_tenants, tenants_arg)
from repro_torch.serving.replay import (                            # noqa: F401
    TraceReplayer, format_report, replay_trace, spec_chunk_cap)
from repro_torch.serving.request import Request, State              # noqa: F401
from repro_torch.serving.roles import (                             # noqa: F401
    DECODE, MIXED, PREFILL, ROLES, Role, build_step_fns, get_role,
    parse_roles, validate_roles)
from repro_torch.serving.sampling import (                          # noqa: F401
    SamplingParams, SamplingRows, sample_tokens, sampling_rows)
from repro_torch.serving.sharded import ShardedEngine               # noqa: F401
from repro_torch.serving.scheduler import (                         # noqa: F401
    Scheduler, SchedulerConfig, StepPlan)
from repro_torch.serving.tracing import (                           # noqa: F401
    TRACE_SCHEMA_VERSION, Tracer, read_trace, validate_trace)

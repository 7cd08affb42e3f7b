"""The superstep engine: scheduler, typed records, sinks, policies and
the run loop (single host: PLaNT, GLL/LCC/paraPLL, the PLL reference
and directed PLaNT; dense or streamed hub-sharded residency)."""

from repro_torch.engine.policies import (DirectedPlantPolicy, GLLPolicy,
                                         PLLRefPolicy, Policy, PlantPolicy,
                                         StepOutcome, build_fingerprint)
from repro_torch.engine.records import (STAT_SLOTS, SuperstepRecord,
                                        fetch_stat_rows, make_record,
                                        pack_stats, record_from_row)
from repro_torch.engine.runner import (PORTED_ALGOS, STREAMING_ALGOS,
                                       EngineResult, run, run_build)
from repro_torch.engine.scheduler import (BatchSchedule, Step, rank_order,
                                          root_batches)
from repro_torch.engine.sink import DenseSink, StreamingShardSink

__all__ = ["BatchSchedule", "DenseSink", "DirectedPlantPolicy",
           "EngineResult", "GLLPolicy", "PLLRefPolicy", "PORTED_ALGOS",
           "PlantPolicy", "Policy", "STAT_SLOTS", "STREAMING_ALGOS", "Step",
           "StepOutcome", "StreamingShardSink", "SuperstepRecord",
           "build_fingerprint", "fetch_stat_rows", "make_record",
           "pack_stats", "rank_order", "record_from_row", "root_batches",
           "run", "run_build"]

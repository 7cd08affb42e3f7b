"""The superstep engine: scheduler, typed records, sinks, policies and
the run loop (single host: PLaNT, GLL/LCC/paraPLL, the PLL reference
and directed PLaNT, on dense or streamed hub-sharded residency; on a
node mesh: DGLL, the Hybrid and distributed PLaNT, whose policy lives
in `repro_torch.engine.dist`)."""

from repro_torch.engine.policies import (DirectedPlantPolicy, GLLPolicy,
                                         PLLRefPolicy, Policy, PlantPolicy,
                                         StepOutcome, build_fingerprint)
from repro_torch.engine.records import (STAT_SLOTS, SuperstepRecord,
                                        fetch_stat_rows, make_record,
                                        pack_stats, record_from_row)
from repro_torch.engine.runner import (PORTED_ALGOS, STREAMING_ALGOS,
                                       EngineResult, run, run_build)
from repro_torch.engine.scheduler import (BatchSchedule, QueueSchedule, Step,
                                          pad_step, rank_order, root_batches)
from repro_torch.engine.sink import (DenseSink, MeshTableSink,
                                     StreamingShardSink)

__all__ = ["BatchSchedule", "DenseSink", "DirectedPlantPolicy",
           "EngineResult", "GLLPolicy", "MeshTableSink", "PLLRefPolicy",
           "PORTED_ALGOS", "PlantPolicy", "Policy", "QueueSchedule",
           "STAT_SLOTS", "STREAMING_ALGOS", "Step", "StepOutcome",
           "StreamingShardSink", "SuperstepRecord", "build_fingerprint",
           "fetch_stat_rows", "make_record", "pack_stats", "pad_step",
           "rank_order", "record_from_row", "root_batches", "run",
           "run_build"]

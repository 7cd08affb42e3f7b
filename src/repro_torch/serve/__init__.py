"""Query serving: the continuous-batching service tier, the
storage-mode answer functions and open-loop load generation."""

from repro_torch.serve.backends import MODES, make_answer_fn
from repro_torch.serve.cache import AnswerCache
from repro_torch.serve.loadgen import poisson_open_loop, zipf_pairs
from repro_torch.serve.query_server import QueryServer, ServerStats
from repro_torch.serve.routing import (RoutedAnswer, ShardUnavailableError,
                                       make_routed_answer_fn)
from repro_torch.serve.service import (CircuitOpenError, QueryService,
                                       QueryTimeoutError,
                                       ServiceOverloadError, Ticket)
from repro_torch.serve.stats import ServiceStats

__all__ = ["MODES", "AnswerCache", "CircuitOpenError", "QueryServer",
           "QueryService", "QueryTimeoutError", "RoutedAnswer",
           "ServerStats", "ServiceOverloadError", "ServiceStats",
           "ShardUnavailableError", "Ticket",
           "make_answer_fn", "make_routed_answer_fn", "poisson_open_loop",
           "zipf_pairs"]

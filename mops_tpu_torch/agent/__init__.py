"""The task agent: a request in plain words -> remapping, streamline or
pathline -> a runnable mops_tpu_torch job script (mirror of mops_tpu.agent,
stdlib only)."""

from .agent import RouteResult, generate_job, route_request, run_agent, run_job
from .llm_client import chat_completion, make_llm, resolve_provider
from .task_templates import (DEFAULT_PATHLINE_CONFIG, DEFAULT_REMAPPING_CONFIG,
                             DEFAULT_STREAMLINE_CONFIG, extract_config,
                             generate_stream_yaml, render_job)

__all__ = ["RouteResult", "route_request", "generate_job", "run_agent",
           "run_job",
           "DEFAULT_REMAPPING_CONFIG", "DEFAULT_STREAMLINE_CONFIG",
           "DEFAULT_PATHLINE_CONFIG", "extract_config", "render_job",
           "generate_stream_yaml", "chat_completion", "make_llm",
           "resolve_provider"]

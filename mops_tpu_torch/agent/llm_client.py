"""Concrete chat-completions HTTP client for the task agent (the port's
copy of mops_tpu.agent.llm_client).

The reference ships an OpenAI/Azure-Foundry client (reference
Agent/llm_task_agent.py:124-178, provider/endpoint resolution :84-121).
``make_llm()`` builds the ``llm(system, user)`` callable from environment
variables / arguments so ``agent.route_request(request, llm=make_llm())``
talks to any OpenAI-compatible chat API; the injected-callable hook remains
the primary extension point (and the offline test path).

stdlib-only (urllib), with bounded exponential-backoff retries on transient
HTTP failures.
"""

from __future__ import annotations

import json
import os
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Callable, List, Optional

PROVIDERS = ("auto", "openai", "foundry")
_AZURE_TAGS = ("azure.com", "ai.azure.com", "services.ai.azure.com")


def _first(*vals) -> str:
    for v in vals:
        if v:
            return str(v)
    return ""


def resolve_provider(provider: str = "auto",
                     base_url: Optional[str] = None,
                     api_key: Optional[str] = None):
    """(provider, base_url, api_key) from args + environment.

    Mirrors the reference's resolution order: explicit argument, then
    FOUNDRY_* / AZURE_* / OPENAI_* env vars; 'auto' becomes 'foundry' when
    the endpoint or keys look Azure-hosted, else 'openai'."""
    base_url = _first(base_url,
                      os.environ.get("FOUNDRY_BASE_URL"),
                      os.environ.get("AZURE_INFERENCE_ENDPOINT"),
                      os.environ.get("AZURE_OPENAI_ENDPOINT"),
                      os.environ.get("OPENAI_BASE_URL"),
                      "https://api.openai.com/v1")
    api_key = _first(api_key,
                     os.environ.get("FOUNDRY_API_KEY"),
                     os.environ.get("AZURE_INFERENCE_API_KEY"),
                     os.environ.get("AZURE_OPENAI_API_KEY"),
                     os.environ.get("OPENAI_API_KEY"))
    if provider == "auto":
        if any(t in base_url.lower() for t in _AZURE_TAGS) or \
                os.environ.get("FOUNDRY_API_KEY") or \
                os.environ.get("AZURE_INFERENCE_API_KEY"):
            provider = "foundry"
        else:
            provider = "openai"
    if provider not in PROVIDERS:
        raise ValueError(f"unknown provider {provider!r} (use {PROVIDERS})")
    return provider, base_url, api_key


def chat_endpoint(base_url: str, provider: str,
                  api_version: str = "", model: str = "") -> str:
    """Chat-completions URL; Azure deployments get the /openai/deployments
    path and an api-version query parameter."""
    url = base_url.rstrip("/")
    if not url.endswith("/chat/completions"):
        if provider == "foundry" and model:
            url += f"/openai/deployments/{model}/chat/completions"
        else:
            url += "/chat/completions"
    if provider == "foundry" and api_version:
        sep = "&" if "?" in url else "?"
        url += sep + urllib.parse.urlencode({"api-version": api_version})
    return url


def chat_completion(messages: List[dict], *, model: str,
                    provider: str = "auto",
                    base_url: Optional[str] = None,
                    api_key: Optional[str] = None,
                    temperature: float = 0.0,
                    timeout: float = 60.0,
                    api_version: str = "",
                    max_retries: int = 3,
                    _opener=None) -> str:
    """POST one chat request, return the assistant message content.

    Retries transient failures (HTTP 408/429/5xx, connection errors) with
    exponential backoff; other HTTP errors raise immediately."""
    provider, base_url, api_key = resolve_provider(provider, base_url, api_key)
    url = chat_endpoint(base_url, provider, api_version, model)
    body = json.dumps({"model": model, "temperature": float(temperature),
                       "messages": messages}).encode()
    headers = {"Content-Type": "application/json"}
    if api_key:
        if provider == "foundry":
            headers["api-key"] = api_key
        else:
            headers["Authorization"] = f"Bearer {api_key}"
    opener = _opener or urllib.request.urlopen

    last_err = None
    for attempt in range(max_retries + 1):
        req = urllib.request.Request(url, data=body, headers=headers,
                                     method="POST")
        try:
            with opener(req, timeout=timeout) as resp:
                raw = resp.read().decode("utf-8")
            break
        except urllib.error.HTTPError as e:
            detail = e.read().decode("utf-8", errors="replace")
            if e.code in (408, 429) or e.code >= 500:
                last_err = RuntimeError(f"LLM API HTTP {e.code}: {detail}")
            else:
                raise RuntimeError(f"LLM API HTTP {e.code}: {detail}") from e
        except urllib.error.URLError as e:
            last_err = RuntimeError(f"LLM API connection failed: {e}")
        if attempt < max_retries:
            time.sleep(min(8.0, 0.5 * 2 ** attempt))
    else:
        raise last_err

    try:
        data = json.loads(raw)
        return data["choices"][0]["message"]["content"]
    except Exception as e:
        raise RuntimeError(f"unexpected LLM response format: {raw!r}") from e


def make_llm(model: Optional[str] = None, **kw) -> Callable[[str, str], str]:
    """Build the ``llm(system, user) -> str`` callable the agent router
    expects (agent.route_request / generate_job)."""
    model = model or os.environ.get("MOPS_LLM_MODEL", "gpt-4o-mini")

    def llm(system: str, user: str) -> str:
        return chat_completion(
            [{"role": "system", "content": system},
             {"role": "user", "content": user}], model=model, **kw)

    return llm

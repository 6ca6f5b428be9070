"""DuckDuckGo search (reference ``web_search.py:32-57``): top-5 results."""
import json
from whisper_mlx_tpu_torch.serving.tools.base import tool, missing_dependency

@tool(
    name="web_search",
    description="Web search (DuckDuckGo); returns the top 5 results with title/url/snippet.",
    parameters={"query": {"type": "string"}},
    required=["query"],
)
def web_search(query: str) -> str:
    try:
        from ddgs import DDGS
    except ImportError:
        try:
            from duckduckgo_search import DDGS  # legacy package name
        except ImportError:
            return missing_dependency("web_search", "ddgs")
    results = list(DDGS().text(query, max_results=5))
    return json.dumps({
        "results": [
            {"title": r.get("title"), "url": r.get("href") or r.get("url"),
             "snippet": r.get("body")}
            for r in results
        ],
    })

TOOL = web_search

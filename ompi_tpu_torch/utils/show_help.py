"""Tagged user-facing messages, each shown once.

The port of ``register_topic`` and ``show_help`` of
``ompi_tpu/utils/show_help.py`` (reference: opal/util/show_help.c): a
message is registered under (topic, key), rendered with ``str.format``
and printed to stderr between banners; a repeated (topic, key) is
rendered but not printed again.
"""

from __future__ import annotations

import sys
import threading
from typing import Dict, Tuple

_messages: Dict[Tuple[str, str], str] = {}
_shown: set = set()
_lock = threading.Lock()


def register_topic(topic: str, key: str, text: str) -> None:
    _messages[(topic, key)] = text


def show_help(topic: str, key: str, once: bool = True, **fmt) -> str:
    """Render and print a message; returns the rendered text. With
    ``once`` a (topic, key) already shown is not printed again."""
    text = _messages.get((topic, key), f"[no help for {topic}:{key}]")
    try:
        rendered = text.format(**fmt)
    except (KeyError, IndexError):
        rendered = text
    with _lock:
        if once and (topic, key) in _shown:
            return rendered
        _shown.add((topic, key))
    banner = "-" * 62
    print(f"{banner}\n{rendered}\n{banner}", file=sys.stderr)
    return rendered

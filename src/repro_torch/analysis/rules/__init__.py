"""Rule registry.  A rule is an object with ``id``, ``name``,
``description`` and ``run(index) -> List[Finding]``; ``@register_rule``
adds an instance to ``RULES``.  Adding a rule = one module here plus an
import below (see docs/static-analysis.md "Adding a rule")."""
from __future__ import annotations

from typing import Iterable, List, Optional

RULES: List[object] = []


def register_rule(cls):
    RULES.append(cls())
    return cls


def get_rules(ids: Optional[Iterable[str]] = None) -> List[object]:
    if ids is None:
        return list(RULES)
    wanted = {i.strip() for i in ids}
    known = {r.id for r in RULES}
    missing = wanted - known
    if missing:
        raise KeyError(f"unknown rule id(s) {sorted(missing)}; "
                       f"have {sorted(known)}")
    return [r for r in RULES if r.id in wanted]


from . import cache_key                       # noqa: E402,F401  R-CACHE
from . import sync                            # noqa: E402,F401  R-SYNC
from . import determinism                     # noqa: E402,F401  R-DET
from . import tracing                         # noqa: E402,F401  R-TRACE
from . import registry_cov                    # noqa: E402,F401  R-REG

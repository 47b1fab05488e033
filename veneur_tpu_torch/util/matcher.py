"""Name/tag matchers for sink routing, tag stripping and the proxy's
`ignore_tags`.

The port's copy of `veneur_tpu.util.matcher`, which mirrors
`util/matcher/matcher.go`: name matchers (any/exact/prefix/regex),
tag matchers (exact/prefix/regex, with `unset` negation), and the
one-config-must-fully-match Match() semantics (`matcher.go:157-183`).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field


class MatcherError(ValueError):
    pass


@dataclass
class NameMatcher:
    kind: str = "any"
    value: str = ""

    def __post_init__(self):
        if self.kind == "any":
            self._match = lambda v: True
        elif self.kind == "exact":
            self._match = lambda v: v == self.value
        elif self.kind == "prefix":
            self._match = lambda v: v.startswith(self.value)
        elif self.kind == "regex":
            rx = re.compile(self.value)
            self._match = lambda v: rx.search(v) is not None
        else:
            raise MatcherError(f'unknown matcher kind "{self.kind}"')

    def match(self, value: str) -> bool:
        return self._match(value)


@dataclass
class TagMatcher:
    kind: str = "exact"
    value: str = ""
    unset: bool = False

    def __post_init__(self):
        if self.kind == "exact":
            self._match = lambda v: v == self.value
        elif self.kind == "prefix":
            self._match = lambda v: v.startswith(self.value)
        elif self.kind == "regex":
            rx = re.compile(self.value)
            self._match = lambda v: rx.search(v) is not None
        else:
            raise MatcherError(f'unknown matcher kind "{self.kind}"')

    def match(self, tag: str) -> bool:
        return self._match(tag)


@dataclass
class Matcher:
    name: NameMatcher = field(default_factory=NameMatcher)
    tags: list[TagMatcher] = field(default_factory=list)


def _from_cfg(cls, cfg):
    if isinstance(cfg, cls):
        return cfg
    return cls(**{k: v for k, v in (cfg or {}).items()})


def matcher_from_config(cfg: dict) -> Matcher:
    name = _from_cfg(NameMatcher, cfg.get("name", {"kind": "any"}))
    tags = [_from_cfg(TagMatcher, t) for t in cfg.get("tags", [])]
    return Matcher(name=name, tags=tags)


def match(matchers: list[Matcher], name: str, tags: list[str]) -> bool:
    """True if any config matches: its name matcher matches AND every tag
    matcher is satisfied (a tag matches unless `unset`, in which case no
    tag may match) — matcher.go:157-183."""
    for cfg in matchers:
        if not cfg.name.match(name):
            continue
        ok = True
        for tm in cfg.tags:
            hit = any(tm.match(tag) for tag in tags)
            if hit and tm.unset:
                ok = False
                break
            if not hit and not tm.unset:
                ok = False
                break
        if ok:
            return True
    return False

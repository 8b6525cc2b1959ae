"""Compiled ACL object.

Reference: acl/acl.go:43 — merges a set of parsed policies into one
capability view. Namespace rules support globs; the most-specific
matching rule wins (the reference scores glob matches by literal prefix
length via its radix tree; same outcome here via sort key).
"""

from __future__ import annotations

import fnmatch
from typing import Optional

from .policy import CAP_DENY, Policy, expand_namespace_policy

_LEVELS = {"": 0, "deny": 0, "read": 1, "write": 2}
# plugin has its own ladder: list < read (the policy validator keeps them
# distinct; collapsing them would give list-scoped tokens read access)
_PLUGIN_LEVELS = {"": 0, "deny": 0, "list": 1, "read": 2}


class ACLError(Exception):
    """Permission denied."""


class ACL:
    def __init__(self, management: bool = False) -> None:
        self.management = management
        # exact-or-glob namespace name -> set of capabilities
        self._namespaces: dict[str, set[str]] = {}
        self.node = ""
        self.agent = ""
        self.operator = ""
        self.plugin = ""

    # -- checks --------------------------------------------------------

    def is_management(self) -> bool:
        return self.management

    def allow_namespace_op(self, namespace: str, capability: str) -> bool:
        if self.management:
            return True
        caps = self._match_namespace(namespace)
        if caps is None or CAP_DENY in caps:
            return False
        return capability in caps

    def allow_namespace(self, namespace: str) -> bool:
        """Any non-deny capability on the namespace (reference
        AllowNamespace)."""
        if self.management:
            return True
        caps = self._match_namespace(namespace)
        return bool(caps) and CAP_DENY not in caps

    def _match_namespace(self, namespace: str) -> Optional[set[str]]:
        if namespace in self._namespaces:
            return self._namespaces[namespace]
        best: Optional[tuple[int, set[str]]] = None
        for pattern, caps in self._namespaces.items():
            if "*" not in pattern and "?" not in pattern:
                continue
            if fnmatch.fnmatchcase(namespace, pattern):
                # specificity = literal characters in the pattern
                score = len(pattern.replace("*", "").replace("?", ""))
                if best is None or score > best[0]:
                    best = (score, caps)
        return best[1] if best else None

    def _level(self, attr: str) -> int:
        levels = _PLUGIN_LEVELS if attr == "plugin" else _LEVELS
        return levels.get(getattr(self, attr), 0)

    def allow_node_read(self) -> bool:
        return self.management or self._level("node") >= 1

    def allow_node_write(self) -> bool:
        return self.management or self._level("node") >= 2

    def allow_agent_read(self) -> bool:
        return self.management or self._level("agent") >= 1

    def allow_agent_write(self) -> bool:
        return self.management or self._level("agent") >= 2

    def allow_operator_read(self) -> bool:
        return self.management or self._level("operator") >= 1

    def allow_operator_write(self) -> bool:
        return self.management or self._level("operator") >= 2

    def allow_plugin_read(self) -> bool:
        return self.management or self._level("plugin") >= 2

    def allow_plugin_list(self) -> bool:
        return self.management or self._level("plugin") >= 1


# The management singleton (reference ManagementACL)
MANAGEMENT_ACL = ACL(management=True)


def compile_policies(policies: list[Policy]) -> ACL:
    """Merge policies. Namespace capabilities union (explicit CAP_DENY
    poisons the namespace); for the coarse node/agent/operator/plugin
    levels an explicit deny ALWAYS wins, exactly like the reference's
    maxPrivilege — a read policy must never override a deny policy."""
    acl = ACL()
    denied: set[str] = set()
    for pol in policies:
        for np in pol.namespaces:
            caps = acl._namespaces.setdefault(np.name, set())
            if np.policy:
                caps.update(expand_namespace_policy(np.policy))
            caps.update(np.capabilities)
        for attr in ("node", "agent", "operator", "plugin"):
            val = getattr(pol, attr)
            if not val:
                continue
            if val == "deny":
                denied.add(attr)
            levels = _PLUGIN_LEVELS if attr == "plugin" else _LEVELS
            if levels.get(val, 0) >= levels.get(getattr(acl, attr), 0):
                setattr(acl, attr, val)
    for attr in denied:
        setattr(acl, attr, "deny")
    return acl

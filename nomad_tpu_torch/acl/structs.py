"""ACL state objects (reference: nomad/structs/structs.go ACLPolicy /
ACLToken)."""

from __future__ import annotations

from dataclasses import dataclass, field

from ..structs.structs import generate_uuid, now_ns

TOKEN_TYPE_CLIENT = "client"
TOKEN_TYPE_MANAGEMENT = "management"

ANONYMOUS_TOKEN_ACCESSOR = "anonymous"


@dataclass
class ACLPolicy:
    name: str = ""
    description: str = ""
    rules: str = ""  # HCL rules text
    create_index: int = 0
    modify_index: int = 0

    def copy(self) -> "ACLPolicy":
        return ACLPolicy(
            name=self.name,
            description=self.description,
            rules=self.rules,
            create_index=self.create_index,
            modify_index=self.modify_index,
        )

    def validate(self) -> None:
        from .policy import parse_policy

        if not self.name:
            raise ValueError("policy: missing name")
        parse_policy(self.rules)


@dataclass
class ACLToken:
    accessor_id: str = ""
    secret_id: str = ""
    name: str = ""
    type: str = TOKEN_TYPE_CLIENT
    policies: list[str] = field(default_factory=list)
    global_: bool = False
    create_time_ns: int = 0
    # 0 = never expires; task-derived tokens carry a TTL and ride the
    # client's renewal loop (reference: 1.4 token expiration +
    # client/vaultclient renewal)
    expiration_time_ns: int = 0
    create_index: int = 0
    modify_index: int = 0

    @staticmethod
    def new(
        name: str = "",
        type: str = TOKEN_TYPE_CLIENT,
        policies: list[str] | None = None,
    ) -> "ACLToken":
        return ACLToken(
            accessor_id=generate_uuid(),
            secret_id=generate_uuid(),
            name=name,
            type=type,
            policies=list(policies or []),
            create_time_ns=now_ns(),
        )

    def copy(self) -> "ACLToken":
        return ACLToken(
            accessor_id=self.accessor_id,
            secret_id=self.secret_id,
            name=self.name,
            type=self.type,
            policies=list(self.policies),
            global_=self.global_,
            create_time_ns=self.create_time_ns,
            expiration_time_ns=self.expiration_time_ns,
            create_index=self.create_index,
            modify_index=self.modify_index,
        )

    def is_management(self) -> bool:
        return self.type == TOKEN_TYPE_MANAGEMENT

    def validate(self) -> None:
        if self.type not in (TOKEN_TYPE_CLIENT, TOKEN_TYPE_MANAGEMENT):
            raise ValueError(f"token: bad type {self.type!r}")
        if self.type == TOKEN_TYPE_CLIENT and not self.policies:
            raise ValueError("client token requires at least one policy")
        if self.type == TOKEN_TYPE_MANAGEMENT and self.policies:
            raise ValueError("management token must not list policies")

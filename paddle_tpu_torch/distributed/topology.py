"""Failure-domain metadata of a multi-node job, after
``paddle_tpu/distributed/topology.py``'s ``FailureDomainMap``.

The rest of that module (``CommunicateTopology``,
``HybridCommunicateGroup`` and the hybrid-parallel groups) is not ported
yet (ROADMAP Queue 1 item 8).
"""
from __future__ import annotations

__all__ = ["FailureDomainMap"]


class FailureDomainMap:
    """Node <-> failure-domain metadata for multi-node jobs.

    Each node is one island of cards (losing the node loses them all at
    once) and nodes are grouped ``dcn_group`` at a time into network
    domains: the hosts behind one data-center link or switch, the blast
    radius of a link flap. The elastic coordinator logs the lost node's
    domains and its correlated peers on every node-loss event. Pure
    metadata, so the launcher can build it before any worker exists."""

    def __init__(self, nodes, dcn_group=2):
        self._nodes = list(nodes)
        self._dcn_group = max(1, int(dcn_group))

    @property
    def nodes(self):
        return list(self._nodes)

    def ici_domain(self, node) -> int:
        return self._nodes.index(node)

    def dcn_domain(self, node) -> int:
        return self._nodes.index(node) // self._dcn_group

    def nodes_in_dcn(self, domain) -> list:
        lo = int(domain) * self._dcn_group
        return self._nodes[lo:lo + self._dcn_group]

    def correlated(self, node) -> list:
        """Peers expected to fail together with ``node`` (same link)."""
        return [n for n in self.nodes_in_dcn(self.dcn_domain(node))
                if n != node]

    def describe(self, node) -> str:
        peers = self.correlated(node)
        tail = (f"; shares a DCN link with {', '.join(peers)}"
                if peers else "")
        return (f"{node}: ici_domain={self.ici_domain(node)} "
                f"dcn_domain={self.dcn_domain(node)}{tail}")

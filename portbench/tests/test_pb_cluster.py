"""The cell's cluster: once set up, every node gossips at the program's
default intervals, as a deployment does, and not at the fast ones it
boots with."""

from types import SimpleNamespace

from portbench.cluster import Cluster


def test_set_up_nodes_gossip_at_the_program_defaults():
    from garage_tpu_torch.net.peering import (CONN_RETRY_INTERVAL,
                                              PING_INTERVAL)
    from garage_tpu_torch.rpc.system import STATUS_EXCHANGE_INTERVAL

    c = Cluster.__new__(Cluster)
    c.garages = [SimpleNamespace(system=SimpleNamespace(
        status_interval=1.0,
        peering=SimpleNamespace(ping_interval=2.0, retry_interval=2.0)))
        for _ in range(3)]
    c.deployed_intervals()
    for g in c.garages:
        assert g.system.status_interval == STATUS_EXCHANGE_INTERVAL == 10.0
        assert g.system.peering.ping_interval == PING_INTERVAL == 15.0
        assert g.system.peering.retry_interval == CONN_RETRY_INTERVAL == 30.0

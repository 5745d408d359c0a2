"""Picklable helpers of the qd tier's tests (no JAX here: the spawned
workers of cross_qd_parallel import this module)."""

import numpy as np
import pytest
import torch

from ttcross_tpu_torch.ops import qd as PQ


class Rank2QD:
    """The JAX tests' separable-plus-separable tensor (exact TT rank 2) in
    qd: prod_c g1[c][i_c] + prod_c g2[c][i_c], on the indices' device."""

    def __init__(self, g1, g2):
        self.g1 = [np.asarray(g, np.float64) for g in g1]
        self.g2 = [np.asarray(g, np.float64) for g in g2]

    def __call__(self, ind):
        i = ind.long().cpu()
        p1 = PQ.qd(torch.ones(i.shape[0], dtype=torch.float64))
        p2 = PQ.qd(torch.ones(i.shape[0], dtype=torch.float64))
        for c in range(len(self.g1)):
            p1 = PQ.qd_mul(p1, PQ.qd(torch.from_numpy(self.g1[c])[i[:, c]]))
            p2 = PQ.qd_mul(p2, PQ.qd(torch.from_numpy(self.g2[c])[i[:, c]]))
        return PQ.QD(*(e.to(ind.device) for e in PQ.qd_add(p1, p2)))


class Broken:
    """An integrand that raises (a worker's failure must fail the run)."""

    def __call__(self, ind):
        raise ArithmeticError("integrand failed")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The qd tests run thousands of small elementwise ops: one intra-op
    thread each (several test processes share the host's cores, and torch's
    thread pool oversubscribed takes minutes over what one thread does in a
    second); the count is restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

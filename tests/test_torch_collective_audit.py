"""The port's all-reduce footprint on two gloo ranks against the JAX
package's audited static counts (tests/test_collective_audit.py).

The JAX audit counts the collective ops of the compiled sharded program;
the port counts its all-reduce calls by site
(:data:`lbfgspp_tpu_torch.parallel.collectives.COUNTS`), so the bars are:
the number of distinct sites of a solve is at most JAX's static count on
every path (6 for L-BFGS with Nocedal-Wright, ``rinv`` the same as
``sweeps``; 27 for the box walks; 60, with at most 2 gathers, for
``gcp="auto"``, whose chunked walk's candidate gather is itself an
all-reduce, as JAX's; 5 for OWL-QN; 12 / 10 for the implicit adjoint with and
without its preconditioner), and an L-BFGS solve's calls are its sites
outside the search once per iteration plus one per line-search trial.
"""

import pytest

from lbfgspp_tpu_torch.tools import spawn_ranks

BUDGET = {"lbfgs_sweeps": 6, "lbfgs_rinv": 6, "box_walk": 27,
          "box_walk_chunked": 27, "box_auto": 60, "owlqn": 5,
          "implicit_True": 12, "implicit_False": 10}


@pytest.fixture(scope="module")
def counts():
    return spawn_ranks.run("lbfgspp_tpu_torch.tools.sharded_cases:audit", 2,
                           timeout=240)


@pytest.mark.parametrize("case", sorted(BUDGET))
def test_sites_within_the_jax_budget(counts, case):
    for rank in counts:
        sites = rank[case]["counts"]
        assert len(sites) <= BUDGET[case], sites
        # the chunked walk's candidate gather is an all-reduce of a
        # zero-filled buffer, as JAX's (cauchy.py:572-582)
        assert sum(1 for s in sites if "gather" in s) <= 2, sites
    assert counts[0][case]["counts"] == counts[1][case]["counts"]


def test_rinv_sites_equal_sweeps(counts):
    assert counts[0]["lbfgs_rinv"]["counts"].keys() == \
        counts[0]["lbfgs_sweeps"]["counts"].keys()


@pytest.mark.parametrize("direction", ["sweeps", "rinv"])
def test_lbfgs_calls_per_iteration(counts, direction):
    """One call of each site outside the search per iteration, one per
    trial of the search (a trial's value and directional derivative
    share it), and the start's once."""
    case = counts[0][f"lbfgs_{direction}"]
    iters, trials = int(case["niter"]), int(case["nfev"]) - 1
    assert case["counts"] == {"lbfgs.init": 1, "lbfgs.dg": iters,
                              "nocedalwright.trial": trials,
                              "history.products": iters,
                              "history.apply_hv": iters}

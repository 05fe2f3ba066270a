"""A request kind that the benchmark's tests register, not the benchmark:
the pair stream over the series backwards (pair n-1 first), judged as the
pair stream is.  It shows that a new kind is a new file alone."""

from benchmark.entries import pair


class BackwardPairs(pair.PairStream):
    def pair_of(self, k: int) -> int:
        return self.n_pairs - 1 - k % self.n_pairs


ENTRY = BackwardPairs
JUDGE = pair.JUDGE
CHECKS = pair.CHECKS
CONTROL = pair.CONTROL

"""The least work of flooding min-sum LDPC decoding, as a decode call
needs it for given LLRs.

Operations: 4 per edge and iteration (the variable-to-check subtraction,
the comparison that keeps the least two magnitudes, the sign parity, the
total's addition), counting for each codeword the iterations that the
reference decoder runs on these LLRs before it stops. Bytes: the channel
LLRs (float32) read once and the outputs (float32 LLRs, int8 bits, one
flag per codeword) written once; the messages are taken to stay on chip.
Both are below what any correct implementation does, so the share of the
bound cannot pass 100%. (The kernel table's per-kernel count, which moves
every message through memory each step, is higher and is not used here.)
"""


def decode(n_edges, n, iters):
    """(ops, bytes) of decoding the codewords whose iteration counts are
    ``iters`` (a sequence) of an ``n``-bit code with ``n_edges`` edges."""
    b = len(iters)
    return 4 * n_edges * int(sum(int(i) for i in iters)), b * n * (4 + 4 + 1) + b

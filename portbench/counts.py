"""The least bytes and operations of the measured work, from shapes alone.

Each count is what the computation needs, whatever implements it: a
later rewrite that fuses or reorders kernels is held to the same number.
Lengths are host integers or sequences of them.
"""

from __future__ import annotations

FP32 = 4


def valid_cells(xn, yn) -> int:
    """The lattice cells a loss reads: sum over utterances of
    frames * (labels + 1)."""
    return sum(int(x) * (int(y) + 1) for x, y in zip(xn, yn))


def lattice_bytes(valid: int) -> int:
    """The lattice sweep and its epilogue: two fp32 log-probs read and two
    fp32 gradients written a valid cell."""
    return 4 * FP32 * valid


def grad_write_bytes(N: int, T: int, U: int, V: int) -> int:
    """The dense (N, T, U, V) fp32 gradient written once, and the
    (N, T, U, 2) fp32 cotangent of the gathered lattice read once."""
    return FP32 * N * T * U * (V + 2)


def loss_call_bytes(N: int, T: int, U: int, V: int, valid: int,
                    calls: int = 1) -> int:
    """``calls`` eager loss and gradient calls over ``valid`` valid cells in
    all: each call's dense gradient written once, and two fp32 log-probs a
    valid cell read once."""
    return calls * FP32 * N * T * U * V + 2 * FP32 * valid


def transducer_flops(N: int, T: int, U: int, feat: int, hidden: int,
                     joint: int, V: int, blocks: int, kernel: int,
                     valid: int) -> int:
    """The least operations of one training step of the conv-GLU / GRU /
    add-mode joint transducer: forward once and backward twice.

    Forward: the encoder's input dense over every frame, each conv block's
    (kernel * hidden) -> (2 * hidden) product over every frame, the GRU's
    input and recurrent products over every label row (U rows: <sos> and
    the labels), the joint's pre-projection on frames and label rows apart
    (add mode: (f + g) W = f W + g W), and its output layer on the valid
    cells only."""
    frames, rows = N * T, N * U
    fwd = (2 * frames * feat * hidden
           + blocks * 2 * frames * (kernel * hidden) * (2 * hidden)
           + 2 * 2 * rows * hidden * (3 * hidden)
           + 2 * (frames + rows) * hidden * joint
           + 2 * valid * joint * V)
    return 3 * fwd

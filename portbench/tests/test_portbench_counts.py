"""The least bytes and operations, against small shapes worked by hand."""

from portbench import counts, peaks


def test_valid_cells():
    # 3 frames x (2 labels + 1) + 2 x (0 + 1)
    assert counts.valid_cells([3, 2], [2, 0]) == 11


def test_lattice_bytes():
    # two fp32 log-probs read and two fp32 gradients written a valid cell
    assert counts.lattice_bytes(11) == 11 * 16


def test_grad_write_bytes():
    # (2, 3, 4, 5) fp32 gradient: 120 x 4 bytes; (2, 3, 4, 2) cotangent:
    # 48 x 4 bytes
    assert counts.grad_write_bytes(2, 3, 4, 5) == 480 + 192


def test_loss_call_bytes():
    # 3 calls: 3 x 480 bytes of gradient, 8 bytes a valid cell read
    assert counts.loss_call_bytes(2, 3, 4, 5, 11, calls=3) == 1440 + 88


def test_transducer_flops():
    # N=1, T=2, U=3, feat 4, hidden 5, joint 6, V 7, one block of kernel 3,
    # 4 valid cells: forward
    #   input dense  2 * 2 * 4 * 5          =   80
    #   conv block   2 * 2 * 15 * 10        =  600
    #   GRU          2 * 2 * 3 * 5 * 15     =  900
    #   joint pre    2 * (2 + 3) * 5 * 6    =  300
    #   joint out    2 * 4 * 6 * 7          =  336
    # times 3 (forward once, backward twice)
    assert counts.transducer_flops(1, 2, 3, 4, 5, 6, 7, 1, 3, 4) == \
        3 * (80 + 600 + 900 + 300 + 336)


def test_peaks():
    assert peaks.card_rates("NVIDIA H100 80GB HBM3") == (3.35e12, 67e12,
                                                          989e12)
    assert peaks.card_rates("NVIDIA H100 PCIe")[0] == 2.0e12

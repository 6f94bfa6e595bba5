"""Operations of the segmentation U-Net's forward (``models/unet.py``'s
architecture: ``depth`` double-conv blocks down, a bottleneck of twice the
last width, stride-2 3 x 3 transposed convs up with skip concatenation and
double convs, a 1 x 1 head), counted from the layer shapes: two operations
a multiply-add, a transposed conv as 9 taps an input pixel. Pooling,
activations, the norm's shift and the softmax are left out (under 0.1% of
the total at these widths)."""


def _conv(hw: int, cin: int, cout: int, taps: int = 9) -> float:
    return 2.0 * hw * cin * cout * taps


def forward_flops(height: int, width: int, depth: int = 3,
                  base_filters: int = 128, in_channels: int = 2,
                  num_classes: int = 2) -> float:
    """Operations of one (height, width) frame's forward; both sides must
    divide by 2 ** depth."""
    if height % 2 ** depth or width % 2 ** depth:
        raise ValueError("the U-Net needs sides divisible by 2 ** depth")
    total, cin, hw = 0.0, in_channels, height * width
    widths = [base_filters * 2 ** i for i in range(depth)]
    for f in widths:
        total += _conv(hw, cin, f) + _conv(hw, f, f)
        cin, hw = f, hw // 4
    total += _conv(hw, cin, 2 * cin) + _conv(hw, 2 * cin, 2 * cin)
    cin = 2 * cin
    for f in reversed(widths):
        total += _conv(hw, cin, f)          # transposed conv, 9 taps an input
        hw *= 4
        total += _conv(hw, 2 * f, f) + _conv(hw, f, f)
        cin = f
    return total + _conv(hw, cin, num_classes, taps=1)


def padded(n: int) -> int:
    """The power of two the program pads a side of ``n`` pixels to."""
    p = 1
    while p < n:
        p *= 2
    return p

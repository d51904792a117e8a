"""Blocks whose words took the native row copy per hundred blocks built
into K4's inputs, in the decompress calls: the program's counters
``k4_input_native_blocks`` over ``k4_input_blocks``.  100 when every
block's words are copied natively; 0 when NumPy index arrays placed
them all."""


def read(ctx):
    from scalce_tpu_torch import timing
    counters = getattr(timing, "counters", None)     # absent: no reading
    got = (counters() if counters else {}).get("decompress", {})
    native, blocks = got.get("k4_input_native_blocks"), got.get(
        "k4_input_blocks")
    if native is None or not blocks:
        return None
    return 100.0 * native / blocks

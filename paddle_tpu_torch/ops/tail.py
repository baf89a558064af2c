"""The reference's name aliases (ref: ``paddle_tpu/ops/tail.py:237-273``).

Only the alias table is here so far: the rest of the reference's
``tail.py`` is still to be ported. An alias whose target the port lacks
is skipped, as the reference's ``_alias`` skips it.
"""

from paddle_tpu_torch.core.registry import GLOBAL_OP_REGISTRY


def _alias(name, target):
    if name not in GLOBAL_OP_REGISTRY and target in GLOBAL_OP_REGISTRY:
        GLOBAL_OP_REGISTRY.register(name, GLOBAL_OP_REGISTRY.get(target),
                                    alias_of=target)


def register_reference_aliases():
    """Called from ``ops/__init__`` after every op module has imported,
    so targets registered later in the import order still resolve."""
    for name, target in (
            ("embedding", "lookup_table"),
            ("topk", "top_k"),
            ("image_resize", "interpolate"),
            ("resize_bilinear", "interpolate"),
            ("resize_nearest", "interpolate"),
            ("warpctc", "ctc_loss"),
            ("smooth_l1", "smooth_l1_loss"),
            ("nce", "nce_loss"),
            ("cross_entropy2", "cross_entropy"),
            ("unique", "unique_with_counts"),
            ("cvm", "continuous_value_model"),
            ("deformable_psroi_pooling", "deformable_psroi_pool"),
            ("deformable_roi_pooling", "deformable_psroi_pool"),
            ("dynamic_lstm", "lstm"),
            ("dynamic_gru", "gru"),
            ("gru_unit", "gru_cell"),
            ("lstm_unit", "lstm_cell"),
            ("While", "while_loop"),
            ("Switch", "switch_case"),
            ("IfElse", "cond"),
            ("StaticRNN", "scan"),
            ("DynamicRNN", "scan"),
            ("Print", "print"),
            ("range", "arange"),
            ("basic_gru", "gru"),
            ("basic_lstm", "lstm"),
            ("BasicGRUUnit", "gru_cell"),
            ("BasicLSTMUnit", "lstm_cell")):
        _alias(name, target)

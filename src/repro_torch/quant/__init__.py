"""Int8 deployment quantization of subspace factors (port of
``repro.quant``): ``SubspacePlan.quantized("int8")`` stamps the plan,
``api.convert.quantize(params, plan)`` packs the params, and
``ServeEngine.from_checkpoint`` serves a quant-stamped checkpoint."""
from repro_torch.quant.quantize import (
    QMAX,
    dequantize_linear,
    dequantize_tensor,
    error_report,
    format_error_report,
    quantize_linear,
    quantize_tensor,
)

__all__ = [
    "QMAX",
    "dequantize_linear",
    "dequantize_tensor",
    "error_report",
    "format_error_report",
    "quantize_linear",
    "quantize_tensor",
]

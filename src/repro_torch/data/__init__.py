from repro_torch.data.synthetic import (
    FAST_FORWARD_BUCKET,
    decode_tokens,
    lm_workload,
    make_lm_payloads,
    make_lm_pipeline,
)

"""xLSTM-1.3B [arXiv:2405.04517; unverified]. sLSTM + mLSTM blocks at 7:1,
no separate FFN on mLSTM blocks (d_ff=0); O(1) recurrent state → runs the
long_500k decode shape."""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50_304,
    head_dim=512,
    pos_embed="none",
    layer_pattern=(("mlstm",) * 7 + ("slstm",)) * 6,
    ssm=SSMConfig(kind="mlstm", d_conv=4, expand=2, num_heads=4),
    max_seq=524_288,
    sub_quadratic=True,
    source="[arXiv:2405.04517; unverified]",
)

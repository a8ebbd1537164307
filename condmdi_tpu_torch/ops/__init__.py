from condmdi_tpu_torch.ops.attention import mha, multihead_attention

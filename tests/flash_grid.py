"""The flash-attention shapes at the tile edges of the tensor-core
kernels (bf16, and float32 in split TF32), shared by the CPU parity tests
(``test_torch_flash_tiles.py``) and the card tests
(``test_torch_cuda.py``): head dims 64 and 128, float32 and bf16, query
and key lengths of 1, one past a 16- or 64-row tile (17, 65), ragged
(200) and unequal (77 over 200, 200 over 77), every mask kind, causal,
and dropout in each dtype. Imports nothing.
"""

DROPOUT_P = 0.1

# name: (head dim, dtype, Sq, Sk, mask kind, causal, dropout)
GRID = {
    "d64_f32_1x1": (64, "float32", 1, 1, None, False, 0.0),
    "d64_bf16_1x1": (64, "bfloat16", 1, 1, None, False, 0.0),
    "d128_f32_1x1_key": (128, "float32", 1, 1, "key", False, 0.0),
    "d128_bf16_17_key": (128, "bfloat16", 17, 17, "key", False, 0.0),
    "d64_f32_17_full_causal": (64, "float32", 17, 17, "full", True, 0.0),
    "d64_bf16_17_bool_causal": (64, "bfloat16", 17, 17, "bool", True, 0.0),
    "d128_f32_17": (128, "float32", 17, 17, None, False, 0.0),
    "d64_bf16_65_causal": (64, "bfloat16", 65, 65, None, True, 0.0),
    "d64_bf16_65_bool": (64, "bfloat16", 65, 65, "bool", False, 0.0),
    "d64_bf16_65_full": (64, "bfloat16", 65, 65, "full", False, 0.0),
    "d128_f32_65_bool": (128, "float32", 65, 65, "bool", False, 0.0),
    "d128_bf16_65": (128, "bfloat16", 65, 65, None, False, 0.0),
    "d64_bf16_200_key": (64, "bfloat16", 200, 200, "key", False, 0.0),
    "d64_f32_200_full": (64, "float32", 200, 200, "full", False, 0.0),
    "d128_bf16_200_causal": (128, "bfloat16", 200, 200, None, True, 0.0),
    "d64_bf16_200_key_causal_dropout": (64, "bfloat16", 200, 200, "key",
                                        True, DROPOUT_P),
    "d64_bf16_77x200_key": (64, "bfloat16", 77, 200, "key", False, 0.0),
    "d64_f32_77x200_causal": (64, "float32", 77, 200, None, True, 0.0),
    "d128_bf16_77x200_full_causal": (128, "bfloat16", 77, 200, "full",
                                     True, 0.0),
    "d128_bf16_77x200_bool": (128, "bfloat16", 77, 200, "bool", False, 0.0),
    "d64_bf16_200x77_causal": (64, "bfloat16", 200, 77, None, True, 0.0),
    "d64_bf16_200x77_full": (64, "bfloat16", 200, 77, "full", False, 0.0),
    "d64_f32_200x77_bool": (64, "float32", 200, 77, "bool", False, 0.0),
    "d128_bf16_200x77_key": (128, "bfloat16", 200, 77, "key", False, 0.0),
    "d64_f32_65_key": (64, "float32", 65, 65, "key", False, 0.0),
    "d64_f32_200_key_causal_dropout": (64, "float32", 200, 200, "key",
                                       True, DROPOUT_P),
    "d128_f32_200x77_full_causal": (128, "float32", 200, 77, "full", True,
                                    0.0),
    "d128_bf16_77x200_bool_dropout": (128, "bfloat16", 77, 200, "bool",
                                      False, DROPOUT_P),
}

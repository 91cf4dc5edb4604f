"""Preset configurations mirroring the reference config files (port of
`faceposegenerator_tpu/configs.py`).

The reference uses plain-module configs; these are the same operating
points as dataclass instances of the port's configs:

  SD21_TRAIN        ↔ `configs/config_train_SD21.py`
  FR_DEFAULT        ↔ `FR_training/config/FR_config.py`
  FR_AUGMENTED      ↔ `FR_training/config/FR_config_Augmented.py` (real+synth
                      merged datasets; output prefix "REC_TFD+Synth_")
  INFERENCE_DEFAULT ↔ `inference_ID-Booth.py:47-69` constants
"""

from __future__ import annotations

import dataclasses

from .training.fr import FRConfig
from .training.idbooth import IDBoothConfig


SD21_TRAIN = IDBoothConfig(
    pretrained_model_name_or_path="stabilityai/stable-diffusion-2-1-base",
    resolution=512,
    instance_prompt="photo of sks person",
    class_prompt="photo of a person",
    with_prior_preservation=True,
    num_class_images=200,
    prior_loss_weight=1.0,
    lora_rank=4,
    train_batch_size=1,
    gradient_accumulation_steps=1,
    num_train_epochs=32,
    validation_epochs=8,
    checkpointing_epochs=8,
    learning_rate=1e-4,
    lr_scheduler="cosine",
    lr_warmup_steps=0,
    max_grad_norm=1.0,
    train_text_encoder=False,
    timestep_loss_weighting=True,
    seed=0,
    losses_to_test=("", "identity", "triplet_prior"),
    validation_prompt="photo of sks person with blue hair",
)

FR_DEFAULT = FRConfig(
    network="iresnet50",
    embedding_size=512,
    dropout=0.4,
    batch_size=128,
    loss="AdaFace",
    s=64.0,
    m=0.35,
    base_lr=0.1,
    max_grad_norm=5.0,
    num_epochs=200,
    lr_steps=(22, 30, 35),
    early_stop_patience=6,
    val_targets=("lfw",),
    models=("DreamBooth", "PortraitBooth", "ID-Booth"),
)

FR_AUGMENTED = dataclasses.replace(FR_DEFAULT)
FR_AUGMENTED_OUTPUT_PREFIX = "REC_TFD+Synth_"


@dataclasses.dataclass(frozen=True)
class InferenceDefaults:
    guidance_scale: float = 5.0
    num_inference_steps: int = 30
    width: int = 512
    height: int = 512
    num_prompts: int = 21
    checkpoint: str = "checkpoint-31-6400"
    seed: int = 0


INFERENCE_DEFAULT = InferenceDefaults()

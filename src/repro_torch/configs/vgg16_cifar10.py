"""The paper's own model: VGG16 and the reduced trainable variant (twin of
``repro/configs/vgg16_cifar10.py``).

Not a transformer config and not an ``ARCHS`` name: it re-exports the
LayeredModel factories of the split-point experiments (Figs. 2-4, Tables
I-II) and the paper's training recipes.
"""
from repro_torch.models.vgg import build_vgg, vgg16, vgg_cifar  # noqa: F401

# Paper training hyperparameters (§V)
TRAIN = dict(epochs=20, lr=5e-3, optimizer="adam")
BOTTLENECK_TRAIN = dict(epochs=50, lr=5e-4, optimizer="adam", compression=0.5)

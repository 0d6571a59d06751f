"""DET002 clean, torch's half: every draw from a seeded torch.Generator."""
import torch


def draw(x, seed: int):
    gen = torch.Generator().manual_seed(seed)
    a = torch.rand(3, generator=gen)
    b = torch.randn(3, 4, generator=gen)
    c = torch.randint(0, 10, (3,), generator=gen)
    d = torch.randperm(5, generator=gen)
    e = torch.normal(0.0, 1.0, (2,), generator=gen)
    f = torch.bernoulli(x, generator=gen)
    g = torch.multinomial(x, 2, generator=gen)
    x.normal_(generator=gen)
    x.uniform_(0.0, 1.0, generator=gen)
    torch.nn.init.normal_(x, generator=gen)
    return a, b, c, d, e, f, g

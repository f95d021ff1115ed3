"""Published peaks by the card's name (torch.cuda.get_device_name()).
NVIDIA's data sheet, H100 SXM5 at its 700 W limit: HBM3 at 3.35 TB/s.
A card not listed has no roofline: the readers then return nothing."""

HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def hbm_bytes_per_s(kind: str):
    return HBM_BYTES_PER_S.get(kind)

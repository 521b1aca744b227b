from nasa_niswan_tpu_torch.data.dataset import Normalizer, zscore_static

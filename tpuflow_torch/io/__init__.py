from tpuflow_torch.io.flo import (read_flo, read_flow, read_juv, write_flo,
                                  write_flow, write_juv)
from tpuflow_torch.io.image import (read_image, read_pfm, read_pgm, write_image,
                                    write_pfm, write_pgm)

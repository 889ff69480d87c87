from .topology import greedy_color, have_native, sorted_row_dedup

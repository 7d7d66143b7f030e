// FMO slice-group map construction for the 7 map types.
// Parity: reference h264bsd_slice_group_map.c:101-589 and
// h264bsdNextMbAddress (h264bsd_util.c:220-246).
#include "slicegroupmap.h"

namespace h264tpu {

namespace {

void interleaved_map(u32* map, u32 n_groups, const std::vector<u32>& run_length,
                     u32 pic_size) {
  u32 i = 0;
  do {
    for (u32 group = 0; group < n_groups && i < pic_size;
         i += run_length[group++]) {
      for (u32 j = 0; j < run_length[group] && i + j < pic_size; ++j) {
        map[i + j] = group;
      }
    }
  } while (i < pic_size);
}

void dispersed_map(u32* map, u32 n_groups, u32 w, u32 h) {
  for (u32 i = 0; i < w * h; ++i) {
    map[i] = ((i % w) + (((i / w) * n_groups) >> 1)) % n_groups;
  }
}

void foreground_leftover_map(u32* map, u32 n_groups,
                             const std::vector<u32>& top_left,
                             const std::vector<u32>& bottom_right, u32 w,
                             u32 h) {
  for (u32 i = 0; i < w * h; ++i) map[i] = n_groups - 1;
  // lower-numbered groups paint over higher-numbered ones
  for (u32 group = n_groups - 1; group--;) {
    u32 y0 = top_left[group] / w, x0 = top_left[group] % w;
    u32 y1 = bottom_right[group] / w, x1 = bottom_right[group] % w;
    for (u32 y = y0; y <= y1; ++y) {
      for (u32 x = x0; x <= x1; ++x) map[y * w + x] = group;
    }
  }
}

void box_out_map(u32* map, bool dir, u32 units_in_group0, u32 w, u32 h) {
  // counter-clockwise (dir=1) or clockwise (dir=0) spiral from the center
  for (u32 i = 0; i < w * h; ++i) map[i] = 1;
  i32 x = i32((w - u32(dir)) >> 1);
  i32 y = i32((h - u32(dir)) >> 1);
  i32 left = x, top = y, right = x, bottom = y;
  i32 x_dir = i32(dir) - 1;
  i32 y_dir = i32(dir);
  bool vacant = false;
  for (u32 k = 0; k < units_in_group0; k += vacant ? 1 : 0) {
    vacant = map[u32(y) * w + u32(x)] == 1;
    if (vacant) map[u32(y) * w + u32(x)] = 0;
    if (x_dir == -1 && x == left) {
      left = std::max(left - 1, 0);
      x = left;
      x_dir = 0;
      y_dir = 2 * i32(dir) - 1;
    } else if (x_dir == 1 && x == right) {
      right = std::min(right + 1, i32(w) - 1);
      x = right;
      x_dir = 0;
      y_dir = 1 - 2 * i32(dir);
    } else if (y_dir == -1 && y == top) {
      top = std::max(top - 1, 0);
      y = top;
      x_dir = 1 - 2 * i32(dir);
      y_dir = 0;
    } else if (y_dir == 1 && y == bottom) {
      bottom = std::min(bottom + 1, i32(h) - 1);
      y = bottom;
      x_dir = 2 * i32(dir) - 1;
      y_dir = 0;
    } else {
      x += x_dir;
      y += y_dir;
    }
  }
}

void raster_scan_map(u32* map, bool dir, u32 upper_left_size, u32 pic_size) {
  for (u32 i = 0; i < pic_size; ++i) {
    map[i] = i < upper_left_size ? u32(dir) : 1 - u32(dir);
  }
}

void wipe_map(u32* map, bool dir, u32 upper_left_size, u32 w, u32 h) {
  u32 k = 0;
  for (u32 j = 0; j < w; ++j) {
    for (u32 i = 0; i < h; ++i) {
      map[i * w + j] = (k++ < upper_left_size) ? u32(dir) : 1 - u32(dir);
    }
  }
}

}  // namespace

void decode_slice_group_map(u32* map, const Pps& pps,
                            u32 slice_group_change_cycle, u32 w, u32 h) {
  const u32 pic_size = w * h;
  if (pps.num_slice_groups == 1) {
    std::memset(map, 0, pic_size * sizeof(u32));
    return;
  }

  u32 units_in_group0 = 0, upper_left_size = 0;
  if (pps.slice_group_map_type > 2 && pps.slice_group_map_type < 6) {
    units_in_group0 = std::min(
        slice_group_change_cycle * pps.slice_group_change_rate, pic_size);
    if (pps.slice_group_map_type >= 4) {
      upper_left_size = pps.slice_group_change_direction
                            ? pic_size - units_in_group0
                            : units_in_group0;
    }
  }

  switch (pps.slice_group_map_type) {
    case 0:
      interleaved_map(map, pps.num_slice_groups, pps.run_length, pic_size);
      break;
    case 1:
      dispersed_map(map, pps.num_slice_groups, w, h);
      break;
    case 2:
      foreground_leftover_map(map, pps.num_slice_groups, pps.top_left,
                              pps.bottom_right, w, h);
      break;
    case 3:
      box_out_map(map, pps.slice_group_change_direction, units_in_group0, w,
                  h);
      break;
    case 4:
      raster_scan_map(map, pps.slice_group_change_direction, upper_left_size,
                      pic_size);
      break;
    case 5:
      wipe_map(map, pps.slice_group_change_direction, upper_left_size, w, h);
      break;
    default:
      for (u32 i = 0; i < pic_size; ++i) map[i] = pps.slice_group_id[i];
      break;
  }
}

u32 next_mb_address(const u32* map, u32 pic_size_in_mbs, u32 curr_mb_addr) {
  // reference h264bsdNextMbAddress util.c:220-246.
  u32 group = map[curr_mb_addr];
  u32 i = curr_mb_addr + 1;
  while (i < pic_size_in_mbs && map[i] != group) i++;
  return i == pic_size_in_mbs ? 0 : i;
}

}  // namespace h264tpu

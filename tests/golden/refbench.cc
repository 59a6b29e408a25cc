// Reference (khmer/liboxli) hot-path timings for BASELINE configs.
// Built against the UNMODIFIED reference library to measure the C++
// rates the device engine is compared with. Usage:
//   refbench count <fastq> [nthreads]     (config 1 hot path)
//   refbench diginorm <fa> <C>            (config 2 hot path)
//   refbench trim <fq>                    (config 3 hot path)
//   refbench hll <fa>                     (config 4 hot path)
//   refbench partition <fa>               (config 5 hot path)
#include <chrono>
#include <cstdio>
#include <string>
#include <thread>
#include <vector>

#include "oxli/hashgraph.hh"
#include "oxli/hllcounter.hh"
#include "oxli/oxli.hh"
#include "oxli/read_parsers.hh"
#include "oxli/subset.hh"

using namespace oxli;
using namespace oxli::read_parsers;
using Clock = std::chrono::steady_clock;

static double secs(Clock::time_point a, Clock::time_point b) {
    return std::chrono::duration<double>(b - a).count();
}

int main(int argc, char** argv) {
    std::string mode = argv[1];
    std::string path = argv[2];

    if (mode == "count") {
        int nthreads = argc > 3 ? atoi(argv[3]) : 1;
        std::vector<uint64_t> sizes = get_n_primes_near_x(4, 50000000);
        Countgraph cg(20, sizes);
        auto parser = get_parser<FastxReader>(path);
        auto t0 = Clock::now();
        unsigned long long total_consumed = 0;
        unsigned int total_reads = 0;
        if (nthreads <= 1) {
            cg.consume_seqfile<FastxReader>(parser, total_reads,
                                            total_consumed);
        } else {
            std::vector<std::thread> ts;
            for (int i = 0; i < nthreads; i++)
                ts.emplace_back([&]() {
                    unsigned int r = 0;
                    unsigned long long c = 0;
                    cg.consume_seqfile<FastxReader>(parser, r, c);
                });
            for (auto& t : ts) t.join();
            // totals via n_unique proxy; re-read counts below
        }
        double dt = secs(t0, Clock::now());
        printf("{\"mode\":\"count\",\"threads\":%d,\"seconds\":%.3f,"
               "\"n_consumed\":%llu,\"n_unique\":%llu}\n",
               nthreads, dt, total_consumed,
               (unsigned long long)cg.n_unique_kmers());
    } else if (mode == "diginorm") {
        int C = argc > 3 ? atoi(argv[3]) : 20;
        std::vector<uint64_t> sizes = get_n_primes_near_x(4, 100000000);
        Countgraph cg(20, sizes);
        auto parser = get_parser<FastxReader>(path);
        auto t0 = Clock::now();
        unsigned long kept = 0, total = 0;
        while (!parser->is_complete()) {
            Read read;
            try { read = parser->get_next_read(); }
            catch (NoMoreReadsAvailable&) { break; }
            read.set_clean_seq();
            total++;
            if (read.cleaned_seq.size() < 20) continue;
            if (!cg.median_at_least(read.cleaned_seq, C)) {
                cg.consume_string(read.cleaned_seq);
                kept++;
            }
        }
        double dt = secs(t0, Clock::now());
        printf("{\"mode\":\"diginorm\",\"seconds\":%.3f,\"total\":%lu,"
               "\"kept\":%lu}\n", dt, total, kept);
    } else if (mode == "trim") {
        // trim-low-abund two-pass hot loop (scripts/trim-low-abund.py
        // :162-300, defaults: -C 2, -Z 20, unpaired, no -V)
        const int CUTOFF = 2, TRIM_AT = 20;
        std::vector<uint64_t> sizes = get_n_primes_near_x(4, 25000000);
        Countgraph cg(20, sizes);
        auto parser = get_parser<FastxReader>(path);
        std::vector<std::string> pass2;
        unsigned long total = 0, trimmed = 0, emitted = 0;
        auto t0 = Clock::now();
        while (!parser->is_complete()) {
            Read read;
            try { read = parser->get_next_read(); }
            catch (NoMoreReadsAvailable&) { break; }
            read.set_clean_seq();
            total++;
            if (read.cleaned_seq.size() < 20) continue;
            BoundedCounterType med; float avg, dev;
            cg.get_median_count(read.cleaned_seq, med, avg, dev);
            if (med >= TRIM_AT) {
                unsigned long at =
                    cg.trim_on_abundance(read.cleaned_seq, CUTOFF);
                if (at >= 20) emitted++;
                if (at < read.cleaned_seq.size()) trimmed++;
            } else {
                cg.consume_string(read.cleaned_seq);
                pass2.push_back(read.cleaned_seq);
            }
        }
        double t_p1 = secs(t0, Clock::now());
        t0 = Clock::now();
        for (const std::string& seq : pass2) {
            unsigned long at = cg.trim_on_abundance(seq, CUTOFF);
            if (at >= 20) emitted++;
            if (at < seq.size()) trimmed++;
        }
        double t_p2 = secs(t0, Clock::now());
        printf("{\"mode\":\"trim\",\"pass1_seconds\":%.3f,"
               "\"pass2_seconds\":%.3f,\"total\":%lu,\"pass2\":%zu,"
               "\"trimmed\":%lu,\"emitted\":%lu}\n",
               t_p1, t_p2, total, pass2.size(), trimmed, emitted);
    } else if (mode == "trimout") {
        // write the exact .abundtrim bytes scripts/trim-low-abund.py
        // would emit for defaults -C 2 -Z 20 on an unpaired FASTQ
        // stream (khmer/trimming.py:38-66 trim_record; utils.py:120
        // write_record; reads < k dropped by broken_paired_reader's
        // min_length=k). Oracle for the repo's full-scale md5 test.
        const int CUTOFF = 2, TRIM_AT = 20;
        const unsigned K = 20;
        std::vector<uint64_t> sizes = get_n_primes_near_x(4, 25000000);
        Countgraph cg(20, sizes);
        auto parser = get_parser<FastxReader>(path);
        FILE* out = fopen(argv[3], "w");
        std::vector<Read> pass2;
        auto emit = [&](const Read& r, unsigned long at) {
            // trim_record: at < k -> drop; at == len -> unmodified
            std::string s = r.sequence, q = r.quality;
            if (at < r.sequence.size()) {
                s = r.sequence.substr(0, at);
                q = q.empty() ? q : r.quality.substr(0, at);
            }
            if (q.empty())
                fprintf(out, ">%s\n%s\n", r.name.c_str(), s.c_str());
            else
                fprintf(out, "@%s\n%s\n+\n%s\n", r.name.c_str(),
                        s.c_str(), q.c_str());
        };
        while (!parser->is_complete()) {
            Read read;
            try { read = parser->get_next_read(); }
            catch (NoMoreReadsAvailable&) { break; }
            if (read.sequence.size() < K) continue;  // min_length=k
            read.set_clean_seq();
            BoundedCounterType med; float avg, dev;
            cg.get_median_count(read.cleaned_seq, med, avg, dev);
            if (med >= TRIM_AT) {
                unsigned long at =
                    cg.trim_on_abundance(read.cleaned_seq, CUTOFF);
                if (at >= K) emit(read, at);
            } else {
                cg.consume_string(read.cleaned_seq);
                pass2.push_back(read);
            }
        }
        for (Read& read : pass2) {
            unsigned long at =
                cg.trim_on_abundance(read.cleaned_seq, CUTOFF);
            if (at >= K) emit(read, at);
        }
        fclose(out);
        printf("{\"mode\":\"trimout\",\"out\":\"%s\"}\n", argv[3]);
    } else if (mode == "normout") {
        // write the exact .keep bytes scripts/normalize-by-median.py
        // would emit (Normalizer.__call__: keep iff NOT median_at_least
        // (cleaned, C), then consume; records written raw via
        // utils.write_record; reads < k dropped by min_length=k).
        const unsigned K = 20;
        int C = atoi(argv[3]);
        std::vector<uint64_t> sizes = get_n_primes_near_x(4, 100000000);
        Countgraph cg(20, sizes);
        auto parser = get_parser<FastxReader>(path);
        FILE* out = fopen(argv[4], "w");
        unsigned long kept = 0, total = 0;
        while (!parser->is_complete()) {
            Read read;
            try { read = parser->get_next_read(); }
            catch (NoMoreReadsAvailable&) { break; }
            if (read.sequence.size() < K) continue;
            read.set_clean_seq();
            total++;
            if (!cg.median_at_least(read.cleaned_seq, C)) {
                cg.consume_string(read.cleaned_seq);
                if (read.quality.empty())
                    fprintf(out, ">%s\n%s\n", read.name.c_str(),
                            read.sequence.c_str());
                else
                    fprintf(out, "@%s\n%s\n+\n%s\n", read.name.c_str(),
                            read.sequence.c_str(), read.quality.c_str());
                kept++;
            }
        }
        fclose(out);
        printf("{\"mode\":\"normout\",\"total\":%lu,\"kept\":%lu}\n",
               total, kept);
    } else if (mode == "hll") {
        HLLCounter hll(0.01, 20);
        auto t0 = Clock::now();
        unsigned int reads = 0;
        unsigned long long consumed = 0;
        hll.consume_seqfile<FastxReader>(path, false, reads, consumed);
        double dt = secs(t0, Clock::now());
        printf("{\"mode\":\"hll\",\"seconds\":%.3f,\"n_consumed\":%llu,"
               "\"estimate\":%llu}\n", dt, consumed,
               (unsigned long long)hll.estimate_cardinality());
    } else if (mode == "partition") {
        std::vector<uint64_t> sizes = get_n_primes_near_x(4, 12500000);
        Nodegraph ng(20, sizes);  // 1e8 bits / 8
        auto parser = get_parser<FastxReader>(path);
        unsigned int total_reads = 0;
        unsigned long long n_consumed = 0;
        auto t0 = Clock::now();
        ng.consume_seqfile_and_tag<FastxReader>(parser, total_reads,
                                                n_consumed);
        double t_tag = secs(t0, Clock::now());
        SubsetPartition subset(&ng);
        t0 = Clock::now();
        subset.do_partition(0, 0, false, true);
        double t_part = secs(t0, Clock::now());
        size_t n_part = 0, n_unassigned = 0;
        subset.count_partitions(n_part, n_unassigned);
        printf("{\"mode\":\"partition\",\"tag_seconds\":%.3f,"
               "\"partition_seconds\":%.3f,\"n_consumed\":%llu,"
               "\"n_partitions\":%zu}\n",
               t_tag, t_part, n_consumed, n_part);
    }
    return 0;
}
